"""The probe A/B tool refuses an edit whose anchor has gone (instead of
timing the source unchanged), and every ``--only`` choice has its
replaced design's C interface."""

import pytest

from lux_tpu_torch import _kernels
from lux_tpu_torch.tools import probe_ab


def test_missing_anchor_raises():
    text = (_kernels.CSRC / _kernels.KERNELS["onehot_reduce"][0]).read_text()
    with pytest.raises(ValueError, match="anchor found 0 times"):
        probe_ab.variant_source(text, [("no such line;", "x")])


def test_every_choice_has_its_replaced_design():
    assert sorted(c for c, _, _ in probe_ab.OLD_ABI.values()) == \
        sorted(probe_ab.CHOICES)
