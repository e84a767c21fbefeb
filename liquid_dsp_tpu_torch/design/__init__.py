"""Host-side coefficient design (numpy float64), ported from
`liquid_dsp_tpu.design` so the port never imports the JAX package."""
from .firdespm import firdespm, firdespm_lowpass  # noqa: F401
from .iirdes import iirdes, iirdes_sos, iirdes_pll_active_lag, iirdes_pll_active_pi  # noqa: F401
