"""Tiny cells built from the committed ones: the same files and drivers,
every width cut so that a run fits the CPU in seconds."""

from __future__ import annotations

import copy

from benchmark import harness

TEXT = "cache.mistral-7b.text-2k"
IMAGE = "cache.llava-mistral.image-mixed"
TINY_TEXT = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=16, vocab_size=520)
TINY_SAE = dict(d_in=64, num_latents=512, k=16)


def tiny_cell(name: str, trace_metrics: bool = False) -> harness.Cell:
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    wl = copy.deepcopy(cell.workload)
    if wl["entry"] == "cache_text":
        cfg.update(TINY_TEXT)
        cfg["sae"] = dict(cfg["sae"], hookpoint="layers.2", **TINY_SAE)
        wl["traffic"].update(ctx_len=32, batch_size=4, check_rows=3, encoder_rows=3, arena_entries=1 << 16)
    elif wl["entry"] == "cache_image":
        cfg["text_config"].update(TINY_TEXT)
        cfg["image_token_index"] = 500
        cfg["vision_config"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                                    num_attention_heads=2, image_size=28, patch_size=14)
        cfg["image_grid_pinpoints"] = [[28, 56], [56, 28], [56, 56], [84, 28], [28, 84]]
        cfg["sae"] = dict(cfg["sae"], hookpoint="model.layers.2", **TINY_SAE)
        wl["traffic"].update(pool_batches=3, check_rows=3, encoder_rows=3, arena_entries=1 << 16,
                             batch=[[40, 53], [28, 28], [25, 75], [60, 107]])
    else:
        raise KeyError(wl["entry"])
    # Limits for these widths: the bf16 program's error at a few layers of
    # 64 is not the cell's; the control's and the faults' read far above.
    tiny_limits = {"act_err": 0.1, "sel_gap": 0.1}
    for name in wl["check"]["limits"]:
        wl["check"]["limits"][name] = tiny_limits.get(name, wl["check"]["limits"][name])
    return harness.Cell(name, wl, cfg, cell.end_to_end, cell.per_layer)
