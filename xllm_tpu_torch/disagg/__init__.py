"""Disaggregated prefill / decode serving and the global KV store (ports of
``xllm_tpu/disagg/``)."""
