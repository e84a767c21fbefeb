"""Streaming compute ops of the PyTorch port (fir, fftfilt, resample, nco,
agc, symsync, equalize, iir, misc_filters, channel)."""
