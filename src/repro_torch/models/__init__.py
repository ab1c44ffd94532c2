"""Model zoo, the dense decoder so far: params are nested dicts of torch
tensors with the JAX package's names and shapes, layers stacked on a
leading axis and walked in a loop; attention is PyTorch's fused
`scaled_dot_product_attention` on the causal train path and a chunked
online softmax elsewhere."""
