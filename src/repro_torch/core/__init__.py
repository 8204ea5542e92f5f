"""Core RTRL engines of the port (counterpart of `repro.core`)."""
