"""The port's interpretation utilities (interp_utils.py) against the JAX
package's: explanation merging, single-SAE loading from a local directory
(and the same failure for a hub name missing from the HuggingFace cache),
the llava image-token span and the notebook display's HTML."""

import json

import numpy as np
import pytest
import torch

import multimodal_sae_tpu.interp_utils as jax_utils
import multimodal_sae_tpu_torch.interp_utils as utils
from multimodal_sae_tpu.features.features import Example as JaxExample
from multimodal_sae_tpu.features.features import Feature as JaxFeature
from multimodal_sae_tpu.features.features import FeatureRecord as JaxFeatureRecord
from multimodal_sae_tpu_torch.config import SaeConfig
from multimodal_sae_tpu_torch.features.features import Example, Feature, FeatureRecord
from multimodal_sae_tpu_torch.sae import Sae


def test_load_explanation_matches_jax(tmp_path):
    (tmp_path / "layers.0.json").write_text(json.dumps([{"layers.0_feature1": "cats", "prompt": "p"},
                                                        {"layers.0_feature4": "dogs"}]))
    (tmp_path / "layers.1.json").write_text(json.dumps([{"layers.1_feature2": "cars", "prompt": "q"}]))
    (tmp_path / "broken.json").write_text("{not json")
    (tmp_path / "notes.txt").write_text("ignored")
    (tmp_path / "sub.json").mkdir()
    got = utils.load_explanation(str(tmp_path))
    assert got == jax_utils.load_explanation(str(tmp_path))
    assert got == {"layers.0_feature1": "cats", "layers.0_feature4": "dogs", "layers.1_feature2": "cars"}


def test_load_single_sae_is_local_only(tmp_path, monkeypatch):
    """A local directory loads as it is; a name that is no local path goes
    to the HuggingFace cache (offline here), and one missing there raises
    what the JAX function raises (tests/test_torch_hub.py loads hub names)."""
    from torch_hub_cache import go_offline

    sae = Sae(8, SaeConfig(num_latents=32, k=4), device="cpu", seed=3)
    sae.save_to_disk(tmp_path / "layers.2")
    got = utils.load_single_sae(str(tmp_path), "layers.2", device="cpu")
    for name, t in sae.params.items():
        assert torch.equal(got.params[name], t)
    go_offline(monkeypatch, tmp_path / "hf_cache")
    raised = []
    for load in (lambda: utils.load_single_sae("org/some-sae-on-the-hub", "layers.2", device="cpu"),
                 lambda: jax_utils.load_single_sae("org/some-sae-on-the-hub", "layers.2")):
        with pytest.raises(FileNotFoundError) as e:
            load()
        raised.append(type(e.value))
    assert raised[0] is raised[1]


def test_get_llava_image_pos_matches_jax():
    for ids in ([1, 5, 9, 9, 9, 2, 3], np.array([9, 4, 4]), [7, 8, 9]):
        assert utils.get_llava_image_pos(ids, 9) == jax_utils.get_llava_image_pos(ids, 9)


class _Tokenizer:
    def batch_decode(self, ids):
        return [f"<{int(i[0])}>" for i in ids]


def test_display_marks_the_active_spans(monkeypatch):
    """The port's HTML equals the JAX package's on the same record and
    tokenizer.  The JAX function imports `display` from
    `IPython.core.display`, which IPython 8+ no longer holds, so both
    modules' `display` are patched to collect what is shown."""
    import IPython.core.display
    import IPython.display

    shown = []
    monkeypatch.setattr(IPython.core.display, "display", shown.append, raising=False)
    monkeypatch.setattr(IPython.display, "display", shown.append, raising=False)
    examples = [(np.array([1, 2, 3, 4]), np.float32([0, 2, 3, 0])), (np.array([5, 6]), np.float32([1, 0])),
                (np.array([7, 8, 9]), np.float32([0.5, 0.2, 4]))]
    record = FeatureRecord(Feature("m", 0))
    record.examples = [Example(t, a) for t, a in examples]
    jax_record = JaxFeatureRecord(JaxFeature("m", 0))
    jax_record.examples = [JaxExample(t, a) for t, a in examples]
    for threshold, n in ((0.5, 2), (0.0, 3), (0.1, 10)):
        shown.clear()
        utils.display(record, _Tokenizer(), threshold=threshold, n=n)
        jax_utils.display(jax_record, _Tokenizer(), threshold=threshold, n=n)
        assert len(shown) == 2
        assert shown[0].data == shown[1].data
    shown.clear()
    utils.display(record, _Tokenizer(), threshold=0.5, n=2)
    assert shown[0].data == "<1><mark><2><3></mark><4><br><br><mark><5></mark><6>"
