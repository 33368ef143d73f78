"""GF(256) math, RS backends (numpy oracle, CPU native, PyTorch, CUDA), CRC32C."""
