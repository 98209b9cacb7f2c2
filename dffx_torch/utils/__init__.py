"""dffx_torch.utils — the TensorBoard event writer, the sanitizers' host half,
profiling helpers (``profiling``) and the environment report (``doctor``)."""
