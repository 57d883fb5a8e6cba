"""scripts/torch_knn_variants.py builds its variants of
ed3dgs_torch/csrc/knn_loss.cu by exact-text substitution on the card. Every
substitution of every variant must occur exactly once in the source, or the
script raises before it builds anything: checked here on the text alone (no
nvcc), so that an edit of knn_loss.cu that moves a substituted line fails a
test on the CPU."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "knn_variants_script", os.path.join(REPO, "scripts", "torch_knn_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _script()
SOURCE = open(os.path.join(REPO, "ed3dgs_torch", "csrc", "knn_loss.cu")).read()


@pytest.mark.parametrize("variant", sorted(SCRIPT.VARIANTS))
def test_every_substitution_is_once_in_knn_loss_cu(variant):
    subs, rows_per_cta = SCRIPT.VARIANTS[variant]
    for old, new in subs:
        assert SOURCE.count(old) == 1, (variant, old)
        assert old != new, (variant, old)
    text = SOURCE
    for old, new in subs:
        text = text.replace(old, new)
    # the variant's K6 rows a CTA, which sizes its loss partials
    assert f"constexpr int R6 = {rows_per_cta};" in text, variant


def test_the_variants_are_the_ones_the_script_documents():
    assert set(SCRIPT.VARIANTS) == {"port", "k6_256", "k7_256"}
    assert SCRIPT.VARIANTS["port"][0] == []
