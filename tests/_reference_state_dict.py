"""Reference-named PyTorch state dicts for the tests of
``utils/torch_compat.py``: the inverse of its mapping.

``reference_state_dict`` names a parameter tree (numpy leaves, the npz
layout) as the original SEA modules name their state dicts: linear weights
[out, in] under ``.weight``, the reference MLPs' ModuleList indices, the
AdaLN ``cond_mlp`` and the sinusoidal tables left out (the reference keeps
them as buffers; the mappers recompute them). chip_smoke.py holds a copy.
"""

import numpy as np
import torch


def reference_state_dict(tree, kind: str, prefix: str = ""):
    """{name: tensor} of a ``kind`` ("spatial" or "temporal") tree, every
    name under ``prefix`` ("module." for an nn.DataParallel export)."""
    sd = {}

    def put(name, a):
        sd[prefix + name] = torch.from_numpy(np.ascontiguousarray(a))

    def lin(name, p):
        put(f"{name}.weight", p["w"].T)
        if "b" in p:
            put(f"{name}.bias", p["b"])

    def norm(name, p):
        put(f"{name}.weight", p["w"])
        if "b" in p:
            put(f"{name}.bias", p["b"])
        if "cond_fc1" in p:
            lin(f"{name}.cond_mlp.0", p["cond_fc1"])
            lin(f"{name}.cond_mlp.2", p["cond_fc2"])

    def attn(name, p):
        for k in ("q", "k", "v"):
            lin(f"{name}.{k}", p[k])
        lin(f"{name}.projection", p["proj"])

    def mlp(name, p):
        idx = 0  # [Linear, LayerNorm, GELU] per hidden layer, then Linear
        for layer in p["layers"]:
            lin(f"{name}.layers.{idx}", layer["lin"])
            if "ln" in layer:
                norm(f"{name}.layers.{idx + 1}", layer["ln"])
                idx += 3
            else:
                idx += 1

    def scale(name, p):
        lin(f"{name}.layer1", p["fc1"])
        lin(f"{name}.layer2", p["fc2"])

    if kind == "spatial":
        norm("encode.ln", tree["ln"])
        for i, b in enumerate(tree["blocks"]):
            norm(f"encode.blocks.{i}.ln_exp1_1", b["ln1"])
            norm(f"encode.blocks.{i}.ln_exp1_2", b["ln2"])
            attn(f"encode.blocks.{i}.attn_1", b["attn"])
            mlp(f"encode.blocks.{i}.mlp_1", b["mlp"])
        mu = "encoders_mu" if "encoders_logvar" in tree else "encoders"
        for g, p in enumerate(tree["encoders"]):
            scale(f"encode.{mu}.{g}", p)
        for g, p in enumerate(tree.get("encoders_logvar", [])):
            scale(f"encode.encoders_logvar.{g}", p)
        for g, p in enumerate(tree["decoders"]):
            scale(f"decode.decoders.{g}", p)
        return sd

    for i, p in enumerate(tree["ln_final"]):
        norm(f"ln.{i}", p)
    for l, b in enumerate(tree["blocks"]):
        n = f"blocks.{l}"
        ib = b["ib"]
        if "W" in ib:
            put(f"{n}.ib.W", ib["W"])
        elif "layers" in ib:
            mlp(f"{n}.ib", ib)
        else:
            lin(f"{n}.ib", ib)
        for i, field in enumerate(b["ln_exp"]):
            for j, p in enumerate(field):
                norm(f"{n}.ln.exp.{i}.{j}", p)
        for i in range(len(b["self_attn"])):
            attn(f"{n}.attn.self.{i}", b["self_attn"][i])
            mlp(f"{n}.mlp.{i}", b["mlp"][i])
            lin(f"{n}.proj.{i}", b["proj"][i])
        for i, p in enumerate(b.get("cross_attn_ib", [])):
            attn(f"{n}.cross_attn_ib.{i}", p)
        for i in range(len(b.get("cross_down", []))):
            lin(f"{n}.cross_down.{i}", b["cross_down"][i])
            lin(f"{n}.cross_up.{i}", b["cross_up"][i])
            norm(f"{n}.ln_cross.{i}", b["ln_cross"][i])
        for i, row in enumerate(b.get("cross_attn", [])):
            if isinstance(row, list):  # sea: the G x G lattice
                for j, p in enumerate(row):
                    attn(f"{n}.cross_attn.{i}.{j}", p)
            else:  # pool: one per field
                attn(f"{n}.cross_attn.{i}", row)
        if "pool_token" in b:
            put(f"{n}.pool_token", b["pool_token"])
            norm(f"{n}.ln_pool", b["ln_pool"])
            upd = b["pool_update"]
            if isinstance(upd, np.ndarray):  # pooling weights
                put(f"{n}.pool_update", upd)
            elif "fc1" in upd:
                lin(f"{n}.pool_update.0", upd["fc1"])
                lin(f"{n}.pool_update.2", upd["fc2"])
            else:
                lin(f"{n}.pool_update", upd)
    return sd
