"""BLIP-2 Q-Former state dict -> the Q-Former parameter tree (the port's copy
of ``myriad_tpu/convert/qformer.py``; numpy only).

Maps the live, query-only subset of the BertLMHeadModel weights that the
reference keeps after pruning: self- and cross-attention, the ``*_query``
FFN branch and the embeddings LayerNorm, under the reference checkpoint's
names ('Qformer.bert....').  Dense kernels come out (in, out), as the JAX
package stores them; ``Myriad.load_pretrained_weights`` reads the tree.
"""

from __future__ import annotations

from typing import Dict

from myriad_tpu_torch.convert.common import f32 as _t


def convert_qformer_state_dict(state_dict: Dict, num_layers: int = 12,
                               cross_attention_freq: int = 2, prefix: str = "bert.") -> Dict:
    sd = {k: _t(v) for k, v in state_dict.items()}

    def dense(name: str) -> Dict:
        return {"kernel": sd[name + ".weight"].T, "bias": sd[name + ".bias"]}

    def norm(name: str) -> Dict:
        return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}

    def attn(pre: str) -> Dict:
        return {"query": dense(pre + "self.query"), "key": dense(pre + "self.key"),
                "value": dense(pre + "self.value"), "attn_out": dense(pre + "output.dense"),
                "attn_ln": norm(pre + "output.LayerNorm")}

    p: Dict = {"embeddings_ln": norm(prefix + "embeddings.LayerNorm")}
    for i in range(num_layers):
        pre = f"{prefix}encoder.layer.{i}."
        layer = {"attention": attn(pre + "attention.")}
        if i % cross_attention_freq == 0:
            layer["crossattention"] = attn(pre + "crossattention.")
        layer["ffn"] = {"intermediate_query": dense(pre + "intermediate_query.dense"),
                        "output_query": dense(pre + "output_query.dense"),
                        "ffn_ln": norm(pre + "output_query.LayerNorm")}
        p[f"layer_{i}"] = layer
    # the BLIP-2 checkpoint carries the learned query embeddings and the
    # ViT-adapter LayerNorm beside the BERT weights: surface both so that
    # the loader can seed Myriad's ``query_tokens`` and ``ln_vision``
    if "query_tokens" in state_dict:
        p["query_tokens"] = _t(state_dict["query_tokens"])
    if "ln_vision.weight" in state_dict:
        # LayerNormFp32 wraps an inner LayerNorm named 'ln'
        p["ln_vision"] = {"ln": {"scale": _t(state_dict["ln_vision.weight"]),
                                 "bias": _t(state_dict["ln_vision.bias"])}}
    return {"params": p}
