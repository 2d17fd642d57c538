"""VertexProgram protocol and the Executor (one device, or one mesh shard)."""
