"""The variants ``launch/ssd_fwd_sweep.py`` builds on the card are text
substitutions of the shipped ``csrc/ssd_scan.cu`` or of the state body it
includes, ``csrc/ssd_state.cuh``: each must still find the text it
replaces exactly once (the sweep checks this only where nvcc runs), so
that a change of the kernel cannot silently leave its sweep behind."""

import pytest

from repro_torch.kernels import _build
from repro_torch.launch.ssd_fwd_sweep import VARIANTS


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_substitutions_are_in_the_shipped_source(name):
    library, edited, subs = VARIANTS[name]
    assert library == "ssd_scan"
    assert edited == f"{library}.cu" or (
        f'#include "{edited}"' in (_build.CSRC / f"{library}.cu").read_text())
    assert name.startswith("ssd_fwd ")
    text = (_build.CSRC / edited).read_text()
    for old, new in subs:
        assert old != new
        assert text.count(old) == 1, f"{name}: {old!r} is not in {edited} exactly once"
