"""The model path of the port: Llama-style attention blocks (dense or
with pruned FFNs served through the SpMM engine) and MoE blocks through
the grouped expert GEMM, with KV-cache decode."""
