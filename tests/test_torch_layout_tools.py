"""The layout scripts (tools/*_layouts.py) against the kernel sources.

Each script builds its variants from text replacements (or plan aliases) in
a copy of ``hisstools_library_tpu_torch/csrc``; a replacement whose text is
no longer in the source stops the script on the card. Here, on the CPU,
every variant of every script is applied to a copy of the sources as they
stand, so a kernel edit that strands a variant fails a test. No nvcc is
needed: nothing is built.
"""

import filecmp
import shutil
import sys
from pathlib import Path

import pytest

TOOLS = Path(__file__).resolve().parents[1] / "tools"
sys.path.insert(0, str(TOOLS))

import layouts  # noqa: E402

SCRIPTS = ("fire_layouts", "small_layouts", "k1_layouts", "k2_layouts", "k4_layouts",
           "k5_layouts", "k8_layouts", "ring_mac_layouts", "bin_layouts")


def _table(mod):
    return getattr(mod, "VARIANTS", None) or mod.LAYOUTS


def _cases():
    out = []
    for script in SCRIPTS:
        mod = __import__(script)
        out += [(script, name) for name in _table(mod)]
    return out


@pytest.mark.parametrize("script,name", _cases())
def test_layout_variant_applies(tmp_path, script, name):
    """The variant's edits apply to the sources as they stand, and make a
    source other than the shipped variant's."""
    mod = __import__(script)
    built = {}
    for v in {"shipped", name}:
        d = built[v] = tmp_path / v
        shutil.copytree(layouts.CSRC, d)
        mod._change(v, d)
    differ = [f.name for f in sorted(layouts.CSRC.iterdir()) if f.is_file()
              and not filecmp.cmp(built["shipped"] / f.name, built[name] / f.name,
                                  shallow=False)]
    assert bool(differ) == (name != "shipped")


def test_replace_once_names_missing_text():
    """A replacement whose text is not in the source, or is there twice,
    stops with the text named."""
    with pytest.raises(SystemExit, match="does not hold 'b' once"):
        layouts.replace_once("a", [("b", "c")], "src")
    with pytest.raises(SystemExit, match="does not hold 'a' once"):
        layouts.replace_once("a a", [("a", "c")], "src")
    assert layouts.replace_once("a b", [("a", "c"), ("b", "d")], "src") == "c d"


def test_variant_names():
    table = {"shipped": (), "x": ()}
    assert layouts.variant_names([], table, "doc") == ["shipped", "x"]
    assert layouts.variant_names(["--only", "x"], table, "doc") == ["x"]
    with pytest.raises(SystemExit, match="no variant y"):
        layouts.variant_names(["--only", "y"], table, "doc")
    with pytest.raises(SystemExit, match="doc"):
        layouts.variant_names(["--bogus"], table, "doc")
