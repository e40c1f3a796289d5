"""HF LLaMA state dict -> the LLaMA parameter tree (the port's copy of
``myriad_tpu/convert/llama.py``; numpy only).

Keys follow HF ``LlamaForCausalLM`` naming (the reference loads Vicuna-7B
through HF ``from_pretrained``).  Dense kernels come out (in, out); with
``config.use_lora`` the peft ``lora_A``/``lora_B`` pairs of q_proj and
v_proj convert where the state dict has them.
"""

from __future__ import annotations

from typing import Dict

from myriad_tpu_torch.convert.common import f32 as _t
from myriad_tpu_torch.models.llama import LlamaConfig


def convert_llama_state_dict(state_dict: Dict, config: LlamaConfig) -> Dict:
    """Returns {"params": ...} in the JAX ``LlamaForCausalLM`` layout."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    model: Dict = {"embed_tokens": {"embedding": sd["model.embed_tokens.weight"]}}
    for i in range(config.num_layers):
        pre = f"model.layers.{i}."
        layer: Dict = {
            "self_attn": {
                "q_proj": {"base": {"kernel": sd[pre + "self_attn.q_proj.weight"].T}},
                "k_proj": {"kernel": sd[pre + "self_attn.k_proj.weight"].T},
                "v_proj": {"base": {"kernel": sd[pre + "self_attn.v_proj.weight"].T}},
                "o_proj": {"kernel": sd[pre + "self_attn.o_proj.weight"].T},
            },
            "mlp": {
                "gate_proj": {"kernel": sd[pre + "mlp.gate_proj.weight"].T},
                "up_proj": {"kernel": sd[pre + "mlp.up_proj.weight"].T},
                "down_proj": {"kernel": sd[pre + "mlp.down_proj.weight"].T},
            },
            "input_layernorm": {"weight": sd[pre + "input_layernorm.weight"]},
            "post_attention_layernorm": {"weight": sd[pre + "post_attention_layernorm.weight"]},
        }
        if config.use_lora:
            for proj in ("q_proj", "v_proj"):
                a_key = pre + f"self_attn.{proj}.lora_A.weight"
                b_key = pre + f"self_attn.{proj}.lora_B.weight"
                if a_key in sd:
                    layer["self_attn"][proj]["lora_a"] = {"kernel": sd[a_key].T}
                    layer["self_attn"][proj]["lora_b"] = {"kernel": sd[b_key].T}
        model[f"layers_{i}"] = layer
    model["norm"] = {"weight": sd["model.norm.weight"]}
    lm_head = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
    return {"params": {"model": model, "lm_head": lm_head.T}}
