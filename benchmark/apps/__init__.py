"""The systems under test: one module per vertex program, which builds
the port's executors for a configuration and runs its jobs through the
port's public entry points."""
