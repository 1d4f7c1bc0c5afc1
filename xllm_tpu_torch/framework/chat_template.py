"""Jinja chat templates.

A copy of ``xllm_tpu/framework/chat_template.py`` (pure Python; the port imports nothing
of the JAX package).

Counterpart of the reference's minja-based JinjaChatTemplate
(reference xllm/core/framework/chat_template/jinja_chat_template.h:18,33,61):
loads the template string from tokenizer_config.json, renders the OpenAI
messages array, with a ChatML fallback for checkpoints without one.
"""

from __future__ import annotations

import json
import os

_CHATML_FALLBACK = (
    "{% for message in messages %}"
    "{{ '<|im_start|>' + message['role'] + '\n' + message['content'] + '<|im_end|>' + '\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}{% endif %}"
)


class ChatTemplate:
    def __init__(self, template: str, bos_token: str = "", eos_token: str = ""):
        import jinja2

        env = jinja2.Environment(
            loader=jinja2.BaseLoader(),
            trim_blocks=True,
            lstrip_blocks=True,
            extensions=["jinja2.ext.loopcontrols"],
        )
        env.globals["raise_exception"] = _raise_exception
        env.filters["tojson"] = lambda x, **kw: json.dumps(x, **kw)
        self._template = env.from_string(template)
        self.bos_token = bos_token
        self.eos_token = eos_token

    @classmethod
    def from_model_path(cls, model_path: str) -> "ChatTemplate":
        template = _CHATML_FALLBACK
        bos = eos = ""
        cfg_path = os.path.join(model_path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            t = cfg.get("chat_template")
            if isinstance(t, str):
                template = t
            elif isinstance(t, list) and t:  # named templates
                for entry in t:
                    if entry.get("name") == "default":
                        template = entry["template"]
                        break
                else:
                    template = t[0].get("template", template)
            bos = _token_str(cfg.get("bos_token"))
            eos = _token_str(cfg.get("eos_token"))
        return cls(template, bos, eos)

    def apply(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tools: list[dict] | None = None,
        **extra,
    ) -> str:
        return self._template.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            tools=tools,
            bos_token=self.bos_token,
            eos_token=self.eos_token,
            **extra,
        )


def _token_str(tok) -> str:
    if isinstance(tok, dict):
        return tok.get("content", "")
    return tok or ""


def _raise_exception(message: str):
    raise ValueError(message)
