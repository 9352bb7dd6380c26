"""The researcher's tools, each a module run as `python -m
multimodal_sae_tpu_torch.tools.<name>` with the flags, defaults, output
files and printed sections of the JAX package's `tools/<name>.py`:

- `model_steering`: one feature clamped, the original and the steered
  generation printed;
- `probe_activations`: the features with the largest mean activation on
  one input, a `filters.json` and, with an image, one highlight PNG each;
- `text_activation_vis`: an HTML heatmap of the filtered features'
  activations over a text;
- `create_filters_from_attribution`: filters, an HTML and PNGs from an
  attribution file;
- `label_explanation`: a concept label for each refined explanation;
- `gpt4o_consistency`: a 0/1 consistency judgement for each label.

The first three run the subject and the SAE on the card (`main(argv=None,
device=None)`: `device=None` is CUDA and raises without a card); the last
three are host programs.  Each splits into a core, a plain function on
inputs already loaded that needs neither PIL, `transformers`,
`safetensors`, `datasets` nor `httpx`, and `main`, which loads the inputs,
calls the core and writes the files."""
