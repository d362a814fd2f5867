"""The port's model code: layers, the paged KV cache and the dense
decoder."""
