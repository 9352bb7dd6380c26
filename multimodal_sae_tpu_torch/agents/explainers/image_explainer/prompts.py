"""Image-explainer prompt (functional equivalent of
reference agents/explainers/image_explainer/prompts.py:3-44).

Contract preserved exactly where downstream code depends on it:
* the reply must end with a line beginning "[EXPLANATION]:" (parsed by
  ImageExplainer.parse_explanation),
* the no-signal sentinel is the literal string
  "Unable to produce descriptions" (checked by the segment scorer,
  reference segment_scorer.py:144-156),
* messages carry the images as base64 PNG data-URLs with the
  "multi-images" modality tag sglang expects.

Copied from multimodal_sae_tpu/agents/explainers/image_explainer/prompts.py; it uses no jax.
"""

SYSTEM = """You are a careful interpretability researcher studying a single neuron inside a vision-language model. Given evidence of where the neuron fires, you write one precise explanation that captures what the neuron responds to."""


GUIDELINES = """
[REQUIREMENTS]

1. Base your analysis ONLY on the visible (highlighted) regions of each image; everything outside them has been blacked out. Skip any image whose visible region is empty or amounts to a few stray pixels.
2. Look for what the visible regions have in common across images: a recurring object, texture, material, scene type, or visual structure.

[GUIDELINES]

Each image you receive shows only the regions where the neuron activated; the rest of the image is masked to black. Complete the following:

1. Caption only what is visible: describe the shared content of the revealed regions. If the revealed regions show no coherent common pattern, or are just scattered specks, reply exactly: "[EXPLANATION]: Unable to produce descriptions."

2. Be brief and literal: state the common visual feature plainly (for example "mesh-like structures" or "actions related to joy or happiness") without speculation about why the neuron exists.

3. Output format: the final line of your reply must start with "[EXPLANATION]:" followed by the description.

If no common visual feature can be determined, reply:

"[EXPLANATION]: Unable to produce descriptions"
"""


def build_prompt(images):
    """Multi-image chat messages (reference prompts.py:28-44)."""
    messages = [{"role": "system", "content": SYSTEM}]
    content = [{"type": "text", "text": GUIDELINES}]
    for image in images:
        content.append(
            {
                "type": "image_url",
                "image_url": {"url": f"data:image/png;base64,{image}"},
                "modalities": "multi-images",
            }
        )
    messages.append({"role": "user", "content": content})
    return messages
