"""The reference's ``utils`` paths: ``utils.debugging`` and
``utils.profiling`` are the port's top-level ``debugging`` and
``profiling`` modules themselves."""
