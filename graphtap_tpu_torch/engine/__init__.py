"""VertexProgram protocol and the one-device Executor."""
