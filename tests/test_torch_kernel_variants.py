"""``tools/kernel_variants.py`` builds its variants of K6 and K3 by text
substitution into the kernels' sources; each substitution must still match
the current sources, or the variant no longer measures what it names."""
import importlib.util
import pathlib

import pytest

_PATH = pathlib.Path(__file__).resolve().parents[1] / "tools" \
    / "kernel_variants.py"
_spec = importlib.util.spec_from_file_location("kernel_variants", _PATH)
KV = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(KV)


@pytest.mark.parametrize("name", list(KV.VARIANTS))
def test_variant_substitutions_match_the_current_sources(name):
    src, subs, _ = KV.VARIANTS[name]
    files = KV.variant_sources(name)
    assert f"{src}.cu" in files
    for old, new in subs:
        assert old not in "".join(files.values()) or old in new
        assert new in "".join(files.values())
