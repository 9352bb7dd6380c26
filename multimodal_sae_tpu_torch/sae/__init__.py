from .model import EncoderOutput, Sae, encode, init_params, pre_acts, select_topk

__all__ = ["EncoderOutput", "Sae", "encode", "init_params", "pre_acts", "select_topk"]
