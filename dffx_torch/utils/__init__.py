"""dffx_torch.utils — the TensorBoard event writer and the sanitizers' host half."""
