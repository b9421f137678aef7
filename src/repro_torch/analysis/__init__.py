"""Runtime checks of the port: a copy of the reference's invariant sanitizer."""
