"""Model configurations of the port (counterpart of `repro.configs`)."""
