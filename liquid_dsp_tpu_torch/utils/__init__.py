"""Host-side utilities (numpy), ported from `liquid_dsp_tpu.utils`."""
