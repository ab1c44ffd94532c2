"""Model zoo, the transformer family (dense, MoE, sliding window, M-RoPE
VLM): params are nested dicts of torch tensors with the JAX package's
names and shapes, layers stacked on a leading axis and walked in a loop;
attention is PyTorch's fused `scaled_dot_product_attention` on the causal
full-sequence path and a chunked online softmax elsewhere (windows, the
KV-cache decode, int8 caches)."""
