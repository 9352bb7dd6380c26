"""Top-level evaluation prompts (functional equivalents of
reference sae_auto_interp/prompt.py:1-90): the 4-way steering-effect rubric,
the concept-taxonomy labeler, and the GPT-4o consistency judge.  Output
contracts (label vocabularies and formats) preserved exactly.

Copied from multimodal_sae_tpu/prompt.py; it uses no jax.
"""

STEERING_FILTER_PROMPT = """You are evaluating how clamping one interpretable feature changed a language model's reply. You get the feature's meaning (LABEL), the model's unsteered reply (ORIGINAL), and its steered reply (STEERED). Decide which of four effects the steering had and answer with the number alone.

Assign exactly one label:

1 - No effect: the steered reply does not engage with the label's concept any more than the original does; the two replies are essentially interchangeable with respect to the concept.
2 - Surface mention: the steered reply names or references the label's concept (possibly repeatedly or awkwardly) without building on it.
3 - Deep incorporation: the steered reply reasons about, elaborates on, or organizes its content around the label's concept.
4 - Derailment: the steered reply becomes incoherent or switches to content unrelated to both the prompt and the label.

Reply with only the single digit 1, 2, 3, or 4 — no explanation.

[LABEL]
{label}

[ORIGINAL]
{original}

[STEERED]
{steered}
"""

CONCEPT_LABEL_PROMPT = """You are a visual-concept taxonomist. Classify the feature description below into exactly one of these categories:

- scene: an overall place or environment (kitchen, beach, cityscape)
- object: a discrete thing (car, dog, guitar)
- part: a component of an object (wheel, sleeve, doorknob)
- material: what something is made of (wood, metal, fabric)
- texture: a surface pattern (striped, mesh-like, speckled)
- color: a dominant color or color scheme

Reply with only the category word, lowercase, nothing else.

[DESCRIPTION]
{description}
"""

GPT_CONSISTENCY_PROMPT = """You will see a feature label and several images; each image shows only the regions where the feature activated (the rest is blacked out). Judge whether the visible regions consistently show the labeled concept across the images.

Answer with a single digit:
1 - consistent: most visible regions clearly show the labeled concept.
0 - inconsistent: the visible regions do not reliably show the labeled concept.

Reply with only 0 or 1.

[LABEL]
{label}
"""
