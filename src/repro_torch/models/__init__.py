"""The model path of the port: Llama-style attention blocks with pruned
FFNs served through the SpMM engine."""
