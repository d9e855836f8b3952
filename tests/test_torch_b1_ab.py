"""The B1 A/B tool's variants stay in step with the kernel source:
each variant's edits apply exactly once to csrc/chunk_partials.cu,
and an edit whose anchor has gone raises instead of timing the source
unchanged."""

from pathlib import Path

import pytest

from lux_tpu_torch.tools import b1_ab

SOURCE = (Path(__file__).resolve().parent.parent / "lux_tpu_torch" / "csrc"
          / "chunk_partials.cu").read_text()


@pytest.mark.parametrize("name", sorted(b1_ab.VARIANTS))
def test_variant_applies_once(name):
    edits = b1_ab.VARIANTS[name]
    out = b1_ab.variant_source(SOURCE, edits)
    assert (out == SOURCE) == (edits == [])
    for anchor, repl in edits:
        assert repl in out


def test_missing_anchor_raises():
    with pytest.raises(ValueError, match="anchor found 0 times"):
        b1_ab.variant_source(SOURCE, [("no such line;", "x")])
