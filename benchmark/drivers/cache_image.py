"""Entry `cache_image`: `FeatureImageCache.run` on LLaVA-NeXT rows, the
image feature cache of the cache_image CLI, on prepared batches (pixel
arrays as the processor hands them over; the card's machine has no PIL).

Traffic (the cell's `traffic`): `pool_batches` batches, each of the
images whose sizes (height, width) `batch` lists, in an order drawn from
the seed, one image a row after BOS and `caption_len` caption ids (0: the
CLI's `<image>` prompt): every batch and every seed has the same work in
another order.  Each image's tiles are N(0, 1) pixels drawn from the seed.
The window cycles through the pool.  Rows are right-padded to their
batch's longest, and the cache drops each row's BOS.  `check_rows` rows of
the window, the longest among them, are compared with the reference, and
`encoder_rows` rows whose hiddens the window kept with the reference
encoder alone."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import weights
from ..reference import anyres
from ..reference import clip as ref_clip
from ..reference import llama as ref_llama
from . import cache_common as cc
from .cache_text import llama_config


def llava_config(cfg: dict):
    from multimodal_sae_tpu_torch.models.clip_vit import ClipVisionConfig
    from multimodal_sae_tpu_torch.models.llava_next import LlavaNextConfig

    vision = {k: v for k, v in cfg["vision_config"].items() if k != "model_type"}
    return LlavaNextConfig(
        text_config=llama_config({**cfg["text_config"], "flash_attention": cfg.get("flash_attention", True)}),
        vision_config=ClipVisionConfig.from_hf(vision),
        image_grid_pinpoints=tuple(map(tuple, cfg["image_grid_pinpoints"])),
        image_token_index=cfg["image_token_index"],
        vision_feature_layer=cfg["vision_feature_layer"],
        vision_feature_select_strategy=cfg["vision_feature_select_strategy"],
    )


def pool(ctx) -> List[dict]:
    """The pool's batches: {"rows": [(prompt ids, (h, w), pixels)], ...}
    prepared as `prepare_inputs` lays them out."""
    t, cfg = ctx.traffic, ctx.config
    vision = cfg["vision_config"]
    tile, patch, pins = vision["image_size"], vision["patch_size"], cfg["image_grid_pinpoints"]
    per_batch = [tuple(s) for s in t["batch"]]
    text_vocab = cfg["image_token_index"]
    out = []
    for b in range(t["pool_batches"]):
        rows = []
        order = cc.rng(ctx.seed, 3, b).permutation(len(per_batch))
        for j, i in enumerate(range(b * len(per_batch), (b + 1) * len(per_batch))):
            r = cc.rng(ctx.seed, 4, i)
            hw = per_batch[order[j]]
            caption = r.integers(1, text_vocab, size=t["caption_len"]).tolist()
            feats = anyres.num_features(hw, pins, tile, patch)
            ids = [1] + caption + [cfg["image_token_index"]] * feats
            pixels = r.standard_normal((anyres.num_tiles(hw, pins, tile), 3, tile, tile), dtype=np.float32)
            rows.append((ids, hw, pixels))
        S = max(len(ids) for ids, _, _ in rows)
        input_ids = np.zeros((len(rows), S), np.int64)
        mask = np.zeros_like(input_ids)
        for j, (ids, _, _) in enumerate(rows):
            input_ids[j, : len(ids)] = ids
            mask[j, : len(ids)] = 1
        out.append({"batch": {"input_ids": input_ids, "attention_mask": mask,
                              "pixel_values": [p for _, _, p in rows], "image_sizes": [hw for _, hw, _ in rows]},
                    "lengths": [len(ids) for ids, _, _ in rows], "S": S,
                    "tiles": sum(p.shape[0] for _, _, p in rows)})
    return out


def setup(ctx) -> dict:
    from multimodal_sae_tpu_torch.device import setup as device_setup
    from multimodal_sae_tpu_torch.features import FeatureImageCache
    from multimodal_sae_tpu_torch.models.llava_next import LlavaNextModel

    device_setup(ctx.device)
    cfg = ctx.config
    hook = cfg["sae"]["hookpoint"]
    with ctx.phase("subject_weights"):
        model = LlavaNextModel(weights.llava_params(cfg, ctx.seed, ctx.device), llava_config(cfg))
    with ctx.phase("sae_weights"):
        sae = cc.make_sae(ctx)
    with ctx.phase("pixels"):
        batches = pool(ctx)

    def capture(batch):
        return ctx.spans.around("capture", model.capture, batch, [hook])

    bs = len(ctx.traffic["batch"])
    keeper = cc.RowKeeper(ctx, hook, bs, skip_bos=True)
    capture = keeper.wrap(cc.plant_faults(ctx, capture))
    with ctx.phase("warmup_batch"):
        warm = cc.new_cache(FeatureImageCache, capture, hook, sae, bs, 0)
        widest = max(range(len(batches)), key=lambda i: batches[i]["S"])
        warm.run(0, iter([batches[widest]["batch"]]), progress=False)
        del warm
    with ctx.phase("prefault_arena"):
        fc = cc.new_cache(FeatureImageCache, capture, hook, sae, bs, cc.prefault_entries(ctx))
    return {"model": model, "sae": sae, "fc": fc, "hook": hook, "keeper": keeper, "pool": batches}


def window(ctx, state) -> dict:
    cfg = ctx.config
    batches, done = state["pool"], {"batches": 0, "tokens": 0}
    text, vision, s = cfg["text_config"], cfg["vision_config"], cfg["sae"]

    def feed():
        b = 0
        while ctx.window.open():
            p = batches[b % len(batches)]
            B, S = len(p["lengths"]), p["S"]
            ctx.work.append({"kind": "clip", "vision": vision, "text_hidden": text["hidden_size"],
                             "tiles": p["tiles"], "layers": cfg["vision_feature_layer"] % (vision["num_hidden_layers"] + 1)})
            ctx.work.append({"kind": "llama", "text": text, "layers": text["num_hidden_layers"], "B": B, "S": S,
                             "valid": p["lengths"]})
            ctx.work.append({"kind": "sae_encode", "d_in": s["d_in"], "latents": s["num_latents"], "k": s["k"],
                             "rows": sum(n - 1 for n in p["lengths"]), "positions": B * (S - 1)})
            done["tokens"] += sum(p["lengths"])
            done["batches"] = b = b + 1
            yield p["batch"]

    cc.run_window(ctx, state, feed())
    n = done["batches"]
    return {"attempted": n, "rows": n * len(ctx.traffic["batch"]),
            "units": {"tokens": done["tokens"]}}


def check(ctx, state, out) -> dict:
    t, cfg = ctx.traffic, ctx.config
    batches, bs = state["pool"], len(t["batch"])
    n_rows = max(out["rows"], 1)

    def where(r):
        p = batches[(r // bs) % len(batches)]
        return p, r % bs

    longest = max(range(min(n_rows, len(batches) * bs)), key=lambda r: where(r)[0]["lengths"][where(r)[1]])
    others = cc.rng(ctx.seed, 2).choice(n_rows, size=min(t["check_rows"], n_rows), replace=False).tolist()
    rows = sorted(set([longest] + others[: t["check_rows"] - 1]))
    entries, empty, kept = cc.written(state, rows, np.array([where(r)[0]["S"] - 1 for r in range(out["rows"])]))
    cc.release(state, keep=("pool",))
    precs = cc.precisions(ctx)
    text = cfg["text_config"]
    layer = int(cfg["sae"]["hookpoint"].rsplit(".", 1)[1])
    image_token = cfg["image_token_index"]
    hiddens = {}
    with torch.no_grad():
        for r in rows:
            p, i = where(r)
            ids = torch.as_tensor(p["batch"]["input_ids"][i : i + 1])
            n = p["lengths"][i]
            per_prec = {}
            for name, prec in precs.items():
                feats = ref_clip.image_features(cfg, ctx.seed, torch.as_tensor(p["batch"]["pixel_values"][i]),
                                                p["batch"]["image_sizes"][i], prec, ctx.device)
                emb = ref_llama.embed_ids(text, ctx.seed, ids, ctx.device)
                slots = (ids[0] == image_token).nonzero().squeeze(1).to(ctx.device)
                if len(slots) != feats.shape[0]:
                    raise AssertionError(f"row {r}: {len(slots)} image slots, {feats.shape[0]} packed features")
                emb[0, slots] = feats
                h = ref_llama.hidden_at(text, ctx.seed, emb, [n], layer, [prec], ctx.device)[0]
                per_prec[name] = h[0, 1:]
                del emb, feats
            hiddens[r] = per_prec
        encoder = cc.Encoder(cfg["sae"], ctx.seed, ctx.device)
        readings = cc.sides(ctx, entries, hiddens, kept, encoder)
    readings["program"]["empty_positions"] = float(empty)
    return readings
