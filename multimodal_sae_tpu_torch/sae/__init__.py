from .model import EncoderOutput, Sae, decode, encode, init_params, pre_acts, select_topk

__all__ = ["EncoderOutput", "Sae", "decode", "encode", "init_params", "pre_acts", "select_topk"]
