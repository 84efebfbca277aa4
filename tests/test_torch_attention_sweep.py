"""The variants ``launch/attention_sweep.py`` builds on the card are text
substitutions of the shipped kernel sources: each must still find the text
it replaces (the sweep checks this only where nvcc runs), so that a change
of a kernel cannot silently leave its sweep behind."""

import pytest

from repro_torch.kernels import _build
from repro_torch.launch.attention_sweep import VARIANTS


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_substitutions_are_in_the_shipped_source(name):
    library, edited, subs = VARIANTS[name]
    assert library in _build.KERNEL_FLAGS
    text = (_build.CSRC / edited).read_text()
    assert edited == f"{library}.cu" or f'#include "{edited}"' in "".join(
        path.read_text() for path in _build.CSRC.iterdir())
    for old, new in subs:
        assert old != new
        assert text.count(old) >= 1, f"{name}: {old!r} is gone from {edited}"
