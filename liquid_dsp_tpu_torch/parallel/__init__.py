"""Device-mesh stream runtime in one process (SURVEY.md §2.12): time-axis
sharding with halo copies and closed-form carry advance, channel-axis data
parallelism, stage pipelining across devices, and the time-sharded
streaming receiver (`liquid_dsp_tpu/parallel/`)."""
from .mesh import Mesh, stream_mesh  # noqa: F401
from .stream import (  # noqa: F401
    time_shard_apply, run_time_sharded, stream_jit,
)
from .pipeline import StagePipeline  # noqa: F401
from .rx import (  # noqa: F401
    preamble_stream_time_sharded, framesync64_time_sharded,
)
