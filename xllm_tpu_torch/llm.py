"""Offline in-process API: the vLLM-style ``LLM`` class.

Counterpart of ``xllm_tpu/llm.py``. Runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from xllm_tpu_torch.config import EngineConfig, ModelConfig
from xllm_tpu_torch.engine import LLMEngine
from xllm_tpu_torch.framework.request import RequestOutput
from xllm_tpu_torch.framework.sampling_params import SamplingParams
from xllm_tpu_torch.models.model_args import load_model_config


class LLM:
    def __init__(
        self,
        model: str = "",
        *,
        config: EngineConfig | None = None,
        device="cuda",
        **kwargs,
    ) -> None:
        if config is None:
            model_cfg = load_model_config(model) if model else ModelConfig()
            config = EngineConfig(model=model_cfg)
            for k, v in kwargs.items():
                for group in (
                    config.scheduler,
                    config.cache,
                    config.parallel,
                    config.quant,
                ):
                    if hasattr(group, k):
                        setattr(group, k, v)
        self.engine = LLMEngine(config, device=device)

    def generate(
        self,
        prompts: list[str] | None = None,
        sampling_params: SamplingParams | list[SamplingParams] | None = None,
        prompt_token_ids: list[list[int]] | None = None,
    ) -> list[RequestOutput]:
        if prompts is None and prompt_token_ids is None:
            raise ValueError("need prompts or prompt_token_ids")
        n = len(prompts) if prompts is not None else len(prompt_token_ids)
        if sampling_params is None:
            sampling_params = SamplingParams()
        sp_list = (
            sampling_params
            if isinstance(sampling_params, list)
            else [sampling_params] * n
        )
        order = []
        for i in range(n):
            req = self.engine.add_request(
                prompt=prompts[i] if prompts else None,
                prompt_token_ids=prompt_token_ids[i] if prompt_token_ids else None,
                sampling_params=sp_list[i],
            )
            order.append(req.request_id)
        outs = {ro.request_id: ro for ro in self.engine.generate_all()}
        return [outs[rid] for rid in order]

    def score(self, prompt_token_ids: list[int]):
        """Per-token logprobs of a prompt (not ported yet: raises)."""
        return self.engine.score_prompt(prompt_token_ids)
