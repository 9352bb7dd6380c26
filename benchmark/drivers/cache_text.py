"""Entry `cache_text`: `FeatureCache.run` on rows of token ids, the text
feature cache of the cache CLI.

Traffic (the cell's `traffic`): `ctx_len` ids a row, `batch_size` rows a
batch, ids uniform over [1, vocab) drawn from the seed and the batch's
number; `arena_entries` entries of the host arena pre-faulted in set-up;
`check_rows` rows of the window, drawn from the seed, are compared with
the reference, and `encoder_rows` rows whose hiddens the window kept with
the reference encoder alone."""

from __future__ import annotations

import numpy as np
import torch

from .. import weights
from ..reference import llama as ref_llama
from . import cache_common as cc


def llama_config(text: dict):
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=text["vocab_size"], hidden_size=text["hidden_size"],
        intermediate_size=text["intermediate_size"], num_hidden_layers=text["num_hidden_layers"],
        num_attention_heads=text["num_attention_heads"], num_key_value_heads=text["num_key_value_heads"],
        head_dim=text.get("head_dim"), rms_norm_eps=text["rms_norm_eps"], rope_theta=text["rope_theta"],
        max_position_embeddings=text["max_position_embeddings"], flash_attention=bool(text.get("flash_attention", True)),
    )


def batch_ids(ctx, b: int) -> np.ndarray:
    t = ctx.traffic
    return cc.rng(ctx.seed, 1, b).integers(1, ctx.config["vocab_size"], size=(t["batch_size"], t["ctx_len"]))


def setup(ctx) -> dict:
    from multimodal_sae_tpu_torch.device import setup as device_setup
    from multimodal_sae_tpu_torch.features import FeatureCache
    from multimodal_sae_tpu_torch.models.llama import LlamaModel

    device_setup(ctx.device)
    cfg = ctx.config
    hook = cfg["sae"]["hookpoint"]
    with ctx.phase("subject_weights"):
        model = LlamaModel(weights.llama_params(cfg, ctx.seed, ctx.device), llama_config(cfg))
    with ctx.phase("sae_weights"):
        sae = cc.make_sae(ctx)

    def capture(batch):
        return ctx.spans.around("capture", model.capture, batch, [hook])

    bs = ctx.traffic["batch_size"]
    keeper = cc.RowKeeper(ctx, hook, bs, skip_bos=False)
    capture = keeper.wrap(cc.plant_faults(ctx, capture))
    with ctx.phase("warmup_batch"):
        warm = cc.new_cache(FeatureCache, capture, hook, sae, bs, 0)
        warm.run(0, iter([{"input_ids": batch_ids(ctx, 2**31)}]), progress=False)
        del warm
    with ctx.phase("prefault_arena"):
        fc = cc.new_cache(FeatureCache, capture, hook, sae, bs, cc.prefault_entries(ctx))
    return {"model": model, "sae": sae, "fc": fc, "hook": hook, "keeper": keeper}


def window(ctx, state) -> dict:
    t, cfg = ctx.traffic, ctx.config
    done = {"batches": 0}

    def batches():
        b = 0
        while ctx.window.open():
            with ctx.span("next_batch"):
                ids = batch_ids(ctx, b)
            ctx.work.append({"kind": "llama", "text": cfg, "layers": cfg["num_hidden_layers"], "B": ids.shape[0],
                             "S": ids.shape[1], "valid": [ids.shape[1]] * ids.shape[0]})
            ctx.work.append({"kind": "sae_encode", "d_in": cfg["sae"]["d_in"], "latents": cfg["sae"]["num_latents"],
                             "k": cfg["sae"]["k"], "rows": ids.size, "positions": ids.size})
            done["batches"] = b = b + 1
            yield {"input_ids": ids}

    cc.run_window(ctx, state, batches())
    n = done["batches"]
    return {"attempted": n, "rows": n * t["batch_size"],
            "units": {"tokens": n * t["batch_size"] * t["ctx_len"]}}


def check(ctx, state, out) -> dict:
    t, cfg = ctx.traffic, ctx.config
    n_rows = max(out["rows"], 1)
    rows = sorted(cc.rng(ctx.seed, 2).choice(n_rows, size=min(t["check_rows"], n_rows), replace=False).tolist())
    entries, empty, kept = cc.written(state, rows, np.full(out["rows"], t["ctx_len"]))
    cc.release(state)
    precs = cc.precisions(ctx)
    bs = t["batch_size"]
    ids = torch.as_tensor(np.stack([batch_ids(ctx, r // bs)[r % bs] for r in rows]))
    layer = int(cfg["sae"]["hookpoint"].rsplit(".", 1)[1])
    with torch.no_grad():
        hs = ref_llama.text_hidden(cfg, ctx.seed, ids, layer, list(precs.values()), ctx.device)
        hiddens = {r: {name: h[i] for name, h in zip(precs, hs)} for i, r in enumerate(rows)}
        encoder = cc.Encoder(cfg["sae"], ctx.seed, ctx.device)
        readings = cc.sides(ctx, entries, hiddens, kept, encoder)
    readings["program"]["empty_positions"] = float(empty)
    return readings
