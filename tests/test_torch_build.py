"""tpu_ocean_torch._build without nvcc: which files the build compiles and
which it hashes into its key. An edited header must change the key, or a
stale library would load."""

from tpu_ocean_torch import _build


def test_sources_compile_cu_and_hash_headers_too():
    compiled, hashed = _build._sources()
    names = {p.name for p in compiled}
    assert {"fft_rows.cu", "fused_rows.cu", "fields_stencil.cu"} <= names
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
