"""One rank of the port's tensor-parallel serving on the CPU
(tests/test_torch_tensor_parallel.py).

    python tests/torch_tp_worker.py RANK WORLD STORE INPUTS OUT

Joins a gloo group of WORLD ranks through ``parallel.mesh.make_mesh``
(``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` as a launcher sets them, the
rendezvous a ``file://`` store, so no port is taken) with the whole world
one model group, then serves what INPUTS (``torch.save``) holds:

* ``engine``: the tiny LLaMA's state dict (fp32), the prompts and the
  engine cases (cache dtype, spec_k): each through ``ServingEngine(model,
  mesh=mesh)`` (the whole model given, sharded by the engine);
* ``myriad``: the tiny Myriad's state dict, its samples and the generate
  cases (spec_k, max_new_tokens): ``Myriad.shard(mesh)``, then
  ``generate`` and the first prefill's logits;
* ``int4``: an int4 LLaMA whose down rows split a group on each rank, its
  prompts and a prefix: the engine (fp32 cache) and ``greedy_generate`` on
  the shard;
* ``chat``: an image, two questions and the sampled turn's settings: on
  the sharded Myriad (``myriad``'s state) a greedy two-turn ``Chat``, a
  sampled ``Chat.answer`` and a top-p ``generate``, with the upload's
  normalisations, expert maps and tower runs counted on this rank.

Writes OUT (``torch.save``): the token ids of every case, the logits, the
collectives counted and this rank's shard shapes.  Imports the port, torch
and numpy only (the test process imports JAX).
"""

import datetime
import os
import sys


def serve_engine(inputs, mesh):
    import torch

    from myriad_tpu_torch.generation import GenerationConfig
    from myriad_tpu_torch.models.layers import Policy
    from myriad_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from myriad_tpu_torch.serving.engine import ServingEngine

    spec = inputs["engine"]
    cfg = GenerationConfig(**spec["gen"])
    out = {}
    for name, (cache_dtype, spec_k) in spec["cases"].items():
        full = LlamaForCausalLM(LlamaConfig.tiny(), policy=Policy.fp32(), device="cpu")
        full.load_state_dict(spec["state"], strict=True)
        eng = ServingEngine(full, slots=2, bucket=64, config=cfg, cache_dtype=cache_dtype,
                            segment=4, admit_widths=(8, 16), spec_k=spec_k, mesh=mesh)
        heads = eng._state["cache"][0]["k"].shape[1]
        for i, p in enumerate(spec["prompts"]):
            eng.submit(torch.as_tensor(p), request_id=i)
        done = {f.request_id: f.tokens.tolist() for f in eng.drain()}
        out[name] = {"tokens": [done[i] for i in range(len(spec["prompts"]))],
                     "cache_heads": heads, "stats": dict(eng.stats)}
    return out


def serve_myriad(inputs, mesh):
    import torch

    from myriad_tpu_torch.models.layers import Policy
    from myriad_tpu_torch.models.myriad import Myriad, MyriadArch

    spec = inputs["myriad"]
    out = {}
    for case, (spec_k, max_new) in spec["cases"].items():
        m = Myriad(MyriadArch.tiny(), policy=Policy.fp32(), device="cpu", use_ve=False,
                   max_txt_len=16, end_sym="###", spec_k=spec_k)
        m.load_state_dicts(spec["state"], None)
        m.shard(mesh)
        logits = []
        llama = m.module.llama
        orig = llama.logits

        def keep(hidden, orig=orig):
            res = orig(hidden)
            logits.append(res.clone())
            return res

        llama.logits = keep
        mesh.reset()
        res = m.generate(spec["samples"], max_new_tokens=max_new)
        out[case] = {"tokens": res["token_ids"].tolist(), "prefill": logits[0],
                     "calls": dict(mesh.calls), "lm_head": tuple(llama.lm_head.shape),
                     "heads": llama.config.num_heads}
    return out


def serve_int4(inputs, mesh):
    import torch

    from myriad_tpu_torch.generation import GenerationConfig, greedy_generate
    from myriad_tpu_torch.models.layers import Policy
    from myriad_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from myriad_tpu_torch.serving.engine import ServingEngine

    spec = inputs["int4"]
    cfg = GenerationConfig(**spec["gen"])
    full = LlamaForCausalLM(LlamaConfig.tiny(**spec["config"]), policy=Policy.fp32(),
                            device="cpu")
    full.load_state_dict(spec["state"], strict=True)
    shard = full.sharded(mesh)
    down = shard.model.layers[0].mlp.down_proj
    eng = ServingEngine(shard, slots=2, bucket=64, config=cfg, cache_dtype=torch.float32,
                        segment=4, admit_widths=(8, 16), mesh=mesh)
    for i, p in enumerate(spec["prompts"]):
        eng.submit(torch.as_tensor(p), request_id=i)
    done = {f.request_id: f.tokens.tolist() for f in eng.drain()}
    tokens = greedy_generate(shard, torch.as_tensor(spec["prefix"]), config=cfg,
                             cache_dtype=torch.float32)
    return {"engine": [done[i] for i in range(len(spec["prompts"]))],
            "generate": tokens.tolist(), "down_rows": down.w_int4.shape[0] * 2,
            "w_int4": {k: v for k, v in shard.state_dict().items() if k.endswith("w_int4")}}


def serve_chat(inputs, mesh):
    import torch

    from myriad_tpu_torch.conversation import conversation
    from myriad_tpu_torch.models.layers import Policy
    from myriad_tpu_torch.models.myriad import Myriad, MyriadArch

    spec = inputs["chat"]
    m = Myriad(MyriadArch.tiny(), policy=Policy.fp32(), device="cpu", use_ve=False,
               max_txt_len=16, end_sym="###")
    m.load_state_dicts(inputs["myriad"]["state"], None)
    m.shard(mesh)
    runs = {"normalise": 0, "maps": 0, "towers": 0}

    def counted(name, fn):
        def run(*a, **k):
            runs[name] += 1
            return fn(*a, **k)
        return run

    conversation.u8_normalize_rows = counted("normalise", conversation.u8_normalize_rows)
    m._expert_maps = counted("maps", m._expert_maps)
    m.module.encode_img = counted("towers", m.module.encode_img)

    def chat_run(questions, **answer_kw):
        chat = conversation.Chat(m)
        conv, img_list = conversation.CONV_VISION.copy(), []
        mesh.reset()
        chat.upload_img(spec["image"], conv, img_list)
        upload_calls = dict(mesh.calls)
        out = []
        for q in questions:
            chat.ask(q, conv)
            out.append(chat.answer(conv, img_list, max_new_tokens=spec["new"],
                                   **answer_kw)[1].tolist())
        return {"tokens": out, "upload_calls": upload_calls, "deltas": chat._delta_log,
                "image_tokens": img_list[0], "cache_heads": chat._cache[0]["k"].shape[1]}

    out = {"greedy": chat_run(spec["questions"]),
           "sampled": chat_run(spec["questions"][:1], **spec["sample"])}
    out["runs"] = dict(runs)  # the two chats' uploads
    out["top_p"] = m.generate(inputs["myriad"]["samples"], max_new_tokens=spec["new"],
                              seed=spec["seed"], **spec["sample"])["token_ids"].tolist()
    return out


def main(argv):
    rank, world, store, inputs_path, out_path = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                                 argv[4])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    import torch

    torch.set_num_threads(1)
    from myriad_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, device="cpu", init_method=f"file://{store}",
                     timeout=datetime.timedelta(seconds=60))
    try:
        make_mesh(3, device="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    inputs = torch.load(inputs_path, weights_only=False)
    with torch.inference_mode():
        out = {"rank": rank, "model_rank": mesh.model_rank, "backend": mesh.backend,
               "refused": refused, "engine": serve_engine(inputs, mesh),
               "myriad": serve_myriad(inputs, mesh), "int4": serve_int4(inputs, mesh),
               "chat": serve_chat(inputs, mesh)}
    torch.save(out, out_path)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
