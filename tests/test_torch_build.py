"""The kernel builder's cache key: a library's name hashes its source and
every local header the source includes, so an edited header rebuilds."""
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as flash_kernel


def _write(root, files):
    for name, text in files.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def test_an_edited_header_changes_the_library_name(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    _write(tmp_path, {"a.cu": '#include <cuda.h>\n#include "h.cuh"\nint a;\n',
                      "h.cuh": "int h;\n", "other.cuh": "int o;\n"})
    src = tmp_path / "a.cu"
    text, lib = build.source_text(src), build.library_path(src)
    assert text == b'#include <cuda.h>\n#include "h.cuh"\nint a;\nint h;\n'
    assert lib.parent == tmp_path / "build" and lib.name.startswith("liba-")
    # a file the source does not include changes nothing
    (tmp_path / "other.cuh").write_text("int o2;\n")
    assert build.library_path(src) == lib
    (tmp_path / "h.cuh").write_text("int h2;\n")
    assert build.source_text(src) != text
    assert build.library_path(src) != lib
    assert not (tmp_path / "build").exists()


def test_each_header_is_read_once_depth_first(tmp_path):
    # h.cuh includes itself, a.cu names it twice and sub/g.cuh once more
    # by another path; sub/i.cuh is found beside the file that names it
    _write(tmp_path, {
        "a.cu": '#include "h.cuh"\n#include "sub/g.cuh"\n#include "h.cuh"\n',
        "h.cuh": '#pragma once\n#include "h.cuh"\n',
        "sub/g.cuh": '#include "../h.cuh"\n  # include "i.cuh"\n',
        "sub/i.cuh": "int i;\n"})
    got = build.source_text(tmp_path / "a.cu")
    want = b"".join((tmp_path / n).read_bytes()
                    for n in ("a.cu", "h.cuh", "sub/g.cuh", "sub/i.cuh"))
    assert got == want


def test_both_attention_sources_hash_the_shared_header():
    header = flash_kernel.SOURCE.with_name("hopper_tc.cuh").read_bytes()
    for src in (flash_kernel.SOURCE, flash_kernel.BWD_SOURCE):
        text = build.source_text(src)
        assert text.startswith(src.read_bytes())
        assert text.count(header) == 1
