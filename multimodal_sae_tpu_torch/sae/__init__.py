from .model import (
    EncoderOutput,
    ForwardOutput,
    Sae,
    decode,
    encode,
    forward,
    init_params,
    pre_acts,
    remove_gradient_parallel_to_decoder_directions,
    select_topk,
    set_decoder_norm_to_unit_norm,
)

__all__ = [
    "EncoderOutput",
    "ForwardOutput",
    "Sae",
    "decode",
    "encode",
    "forward",
    "init_params",
    "pre_acts",
    "remove_gradient_parallel_to_decoder_directions",
    "select_topk",
    "set_decoder_norm_to_unit_norm",
]
