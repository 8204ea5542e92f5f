"""Training runtimes of the port (counterpart of `repro.runtime`)."""
