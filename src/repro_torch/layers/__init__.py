"""Model layers of the port (dense decoder: norms, rotary embeddings,
SwiGLU MLP, grouped-query attention)."""
