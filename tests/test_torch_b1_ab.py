"""The B1 A/B tool's variants stay in step with the kernel sources:
each variant's edits apply exactly once to csrc/chunk_partials.cu (and,
for ``--batched``, to csrc/chunk_partials_batched.cu), and an edit
whose anchor has gone raises instead of timing the source unchanged."""

from pathlib import Path

import pytest

from lux_tpu_torch.tools import b1_ab

CSRC = Path(__file__).resolve().parent.parent / "lux_tpu_torch" / "csrc"
SOURCE = (CSRC / "chunk_partials.cu").read_text()
BATCHED_SOURCE = (CSRC / "chunk_partials_batched.cu").read_text()

CASES = ([pytest.param(SOURCE, b1_ab.VARIANTS[n], id=n)
          for n in sorted(b1_ab.VARIANTS)]
         + [pytest.param(BATCHED_SOURCE, b1_ab.BATCHED_VARIANTS[n],
                         id=f"batched_{n}")
            for n in sorted(b1_ab.BATCHED_VARIANTS)])


@pytest.mark.parametrize("source, edits", CASES)
def test_variant_applies_once(source, edits):
    out = b1_ab.variant_source(source, edits)
    assert (out == source) == (edits == [])
    for anchor, repl in edits:
        assert repl in out


def test_missing_anchor_raises():
    with pytest.raises(ValueError, match="anchor found 0 times"):
        b1_ab.variant_source(SOURCE, [("no such line;", "x")])
