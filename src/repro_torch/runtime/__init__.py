"""Step functions of the port: serving (prefill, decode) and sparse
fine-tuning."""
