"""The tuning tools' patched builds (``tools_torch/variants.py``) on the
CPU: the copy and its patches, the refusals, the ptxas log's reading, and
every variant of each tool patching this tree's kernel sources (a patch
that no longer matches the text it replaces would stop the tool on the
card). Building and timing a variant needs ``nvcc`` and a card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools_torch import variants  # noqa: E402


def _tree(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cuh").write_text("constexpr int kA = 1;\nint f();\n")
    (src / "b.cu").write_text('#include "a.cuh"\n')
    return src


def test_patched_copy_applies_each_patch_to_a_copy(tmp_path):
    src = _tree(tmp_path)
    dst = variants.patched_copy(tmp_path / "v", [
        ("a.cuh", "constexpr int kA = 1;", "constexpr int kA = 2;"),
        ("b.cu", ("#include \"c.cuh\"", "#include \"a.cuh\""), "// none")],
        csrc=src)
    assert (dst / "a.cuh").read_text() == "constexpr int kA = 2;\nint f();\n"
    assert (dst / "b.cu").read_text() == "// none\n"
    assert (src / "a.cuh").read_text().startswith("constexpr int kA = 1;")
    # a second copy of the same name starts from the sources again
    again = variants.patched_copy(tmp_path / "v", [], csrc=src)
    assert (again / "b.cu").read_text() == '#include "a.cuh"\n'


def test_patched_copy_refuses_a_patch_that_does_not_apply(tmp_path):
    src = _tree(tmp_path)
    with pytest.raises(ValueError, match="patch not found in a.cuh"):
        variants.patched_copy(tmp_path / "v", [("a.cuh", "kB", "kC")],
                              csrc=src)
    with pytest.raises(FileNotFoundError):
        variants.patched_copy(tmp_path / "v", [("c.cuh", "x", "y")],
                              csrc=src)
    # skip_missing: a file the tree lacks is skipped, but some patch must
    # apply
    dst = variants.patched_copy(
        tmp_path / "v", [("c.cuh", "x", "y"), ("a.cuh", "kA = 1", "kA = 3")],
        csrc=src, skip_missing=True)
    assert "kA = 3" in (dst / "a.cuh").read_text()
    with pytest.raises(ValueError, match="no patch applies"):
        variants.patched_copy(tmp_path / "v", [("c.cuh", "x", "y")],
                              csrc=src, skip_missing=True)


def test_ptxas_usage_reads_registers_and_spills():
    log = ("ptxas info    : Compiling entry function '_Z3fooPf' for "
           "'sm_90a'\n"
           "ptxas info    : Function properties for _Z3fooPf\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 40 registers, 352 bytes cmem[0]\n")
    assert variants.ptxas_usage(log) == {
        "_Z3fooPf": "Used 40 registers, 352 bytes cmem[0]",
        "_Z3fooPf spills": ("8 bytes stack frame, 4 bytes spill stores, 4 "
                            "bytes spill loads")}


def _tool_variants():
    """(tool, variant, patches, skip_missing) of every tool's variants."""
    from tools_torch import (tune_gram_rows, tune_intervals,
                             tune_three_pass, tune_tiled)

    out = []
    for tool, table, skip in (
            ("tune_gram_rows", tune_gram_rows.VARIANTS, False),
            ("tune_tiled", {**tune_tiled.VARIANTS, **tune_tiled.ABLATIONS},
             False),
            ("tune_intervals", {**tune_intervals.VARIANTS,
                                **tune_intervals.ABLATIONS}, False),
            ("tune_three_pass", tune_three_pass.VARIANTS, True)):
        out += [(tool, name, patches, skip)
                for name, patches in table.items()]
    return out


@pytest.mark.parametrize("tool", ["tune_gram_rows", "tune_tiled",
                                  "tune_intervals", "tune_three_pass"])
def test_every_tool_variant_patches_this_tree(tool, tmp_path):
    """Each variant of ``tool`` applies to this tree's sources, and
    changes them unless it is the shipped one."""
    from safeopt_torch.ops import _build

    cases = [c for c in _tool_variants() if c[0] == tool]
    assert cases
    for _, name, patches, skip in cases:
        dst = variants.patched_copy(tmp_path / name, patches,
                                    skip_missing=skip)
        changed = [f.name for f in dst.iterdir()
                   if f.read_text() != (_build._CSRC / f.name).read_text()]
        assert bool(changed) == bool(patches), (name, changed)
