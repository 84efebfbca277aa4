"""The variants ``launch/ssd_bwd_sweep.py`` builds on the card are text
substitutions of the shipped ``csrc/ssd_scan_bwd.cu``: each must still find
the text it replaces (the sweep checks this only where nvcc runs), so that
a change of the kernel cannot silently leave its sweep behind."""

import pytest

from repro_torch.kernels import _build
from repro_torch.launch.ssd_bwd_sweep import VARIANTS


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_substitutions_are_in_the_shipped_source(name):
    library, edited, subs = VARIANTS[name]
    assert library == "ssd_scan_bwd" and edited == f"{library}.cu"
    assert name.startswith("ssd_bwd ")
    text = (_build.CSRC / edited).read_text()
    for old, new in subs:
        assert old != new
        assert text.count(old) == 1, f"{name}: {old!r} is not in {edited} exactly once"
