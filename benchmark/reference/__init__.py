"""The plain reference of the training step: plain PyTorch, float32 unless
a precision is asked for, no kernel, no fusion, and nothing of the port."""
