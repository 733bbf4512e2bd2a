"""tpu_ocean_torch._build without nvcc: which files the build compiles and
which it hashes into its key (an edited header must change the key, or a
stale library would load), and the build's compile-then-link order through
a stand-in nvcc."""

import sys

import pytest

from tpu_ocean_torch import _build

# writes each output file with the inputs it was given; fails on "bad.cu"
FAKE_NVCC = f"""#!{sys.executable}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
inputs = [a for a in args if a.endswith((".cu", ".o")) and a != out]
if any(a.endswith("bad.cu") for a in inputs):
    print("error in bad.cu")
    sys.exit(2)
open(out, "w").write(" ".join(inputs))
print("built", out)
"""


def test_sources_compile_cu_and_hash_headers_too():
    compiled, hashed = _build._sources()
    names = {p.name for p in compiled}
    assert {"fft_rows.cu", "fused_rows.cu", "fields_stencil.cu",
            "fields_stencil_v1.cu", "gerstner_bank.cu"} <= names
    assert all(p.suffix == ".cu" for p in compiled)
    assert "stockham.cuh" in {p.name for p in hashed}
    assert set(compiled) < set(hashed)


def test_editing_a_header_changes_the_build_key(tmp_path):
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    header = tmp_path / "b.cuh"
    header.write_text("// one\n")
    compiled, hashed = _build._sources(tmp_path)
    assert [p.name for p in compiled] == ["a.cu"]
    before = _build._digest(hashed)
    header.write_text("// two\n")
    assert _build._digest(_build._sources(tmp_path)[1]) != before


def test_every_c_entry_has_a_signature():
    sources = "".join(p.read_text() for p in _build._sources()[0])
    for name, argtypes in _build._SIGNATURES.items():
        head = sources[sources.index(f"int {name}("):]
        params = head[:head.index(")")]
        assert params.count(",") + 1 == len(argtypes), name


@pytest.mark.parametrize("fails", [False, True])
def test_each_source_compiles_then_one_link(tmp_path, monkeypatch, fails):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    names = ["a.cu", "b.cu"] + (["bad.cu"] if fails else [])
    sources = [tmp_path / name for name in names]
    for src in sources:
        src.write_text("")
    out = tmp_path / "out"
    out.mkdir()
    if fails:
        with pytest.raises(RuntimeError, match="error in bad.cu"):
            _build._compile_and_link(sources, out)
        assert not (out / _build.LIB_NAME).exists()
        return
    log = _build._compile_and_link(sources, out)
    for src in sources:
        assert (out / f"{src.stem}.o").read_text() == str(src)
    assert (out / _build.LIB_NAME).read_text() == f"{out / 'a.o'} {out / 'b.o'}"
    assert log.count("built") == 3
