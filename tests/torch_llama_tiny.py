"""A tiny LLaMA for the port's generation and steering tests
(test_torch_generate.py, test_torch_steering.py): 3 layers, hidden 64, 4
heads, 2 kv heads, vocab 256, fp32, drawn with numpy from a seed in the JAX
package's layout and carried to the port by `convert.llama_params_from_jax`.
Matrices are normal / sqrt(fan-in) and the LM head's too, so logits have a
spread of about 1 and top-2 gaps are rarely near ties."""

import numpy as np

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2)


def numpy_params(seed: int = 0) -> dict:
    """The tiny LLaMA's weights as numpy arrays in the JAX layout ((in, out)
    projections, `lm_head` (D, V))."""
    rng = np.random.default_rng(seed)
    D, I, V = TINY["hidden_size"], TINY["intermediate_size"], TINY["vocab_size"]
    H, kvH = TINY["num_attention_heads"], TINY["num_key_value_heads"]
    hd = D // H

    def mat(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    def norm():
        return (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    layers = [dict(input_layernorm=norm(), q_proj=mat(D, H * hd), k_proj=mat(D, kvH * hd), v_proj=mat(D, kvH * hd),
                   o_proj=mat(H * hd, D), post_attention_layernorm=norm(), gate_proj=mat(D, I), up_proj=mat(D, I),
                   down_proj=mat(I, D)) for _ in range(TINY["num_hidden_layers"])]
    return dict(embed_tokens=rng.standard_normal((V, D)).astype(np.float32), layers=layers, norm=norm(),
                lm_head=mat(D, V))


def models(seed: int = 0, flash: bool = False):
    """(JAX LlamaModel, port LlamaModel on the CPU) with the same weights."""
    import jax
    import jax.numpy as jnp

    from multimodal_sae_tpu.models import llama as jl
    from multimodal_sae_tpu_torch.convert import llama_params_from_jax
    from multimodal_sae_tpu_torch.models import llama as pl

    params = numpy_params(seed)
    jmodel = jl.LlamaModel(jax.tree_util.tree_map(jnp.asarray, params), jl.LlamaConfig(**TINY, flash_attention=flash))
    return jmodel, pl.LlamaModel(llama_params_from_jax(params, device="cpu"), pl.LlamaConfig(**TINY, flash_attention=flash))
