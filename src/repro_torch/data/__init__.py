"""Data streams of the port (counterpart of `repro.data`)."""
