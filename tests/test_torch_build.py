"""The port's build glue on the CPU, where no ``nvcc`` runs: the ctypes
signatures of ``kernels/_build.py`` against the ``extern "C"`` entry
points in ``csrc/*.cu``, and the build hash against every flag.

A signature that disagrees with its C declaration passes arguments in the
wrong registers and shows only on the card, as a wrong result or a fault;
a hash that misses a flag reuses a library built with other flags.
"""
import ctypes
import re

import pytest

from repro_torch.kernels import _build

# C parameter type -> the ctypes type the binding must declare for it
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _entry_points() -> dict:
    """name -> list of C parameter types, for every ``extern "C"`` function."""
    found = {}
    for path in _build.sources():
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, params in re.findall(r'extern\s+"C"\s+[\w\s\*]+?\b(repro_\w+)\s*\(([^)]*)\)',
                                       text):
            types = []
            for param in filter(None, (p.strip() for p in params.split(","))):
                decl = re.sub(r"\bconst\b", "", param)
                if "*" in decl:
                    types.append(ctypes.c_void_p)
                else:
                    types.append(_C_TYPES[" ".join(decl.split()[:-1])])
            found[name] = types
    return found


def test_every_entry_point_has_a_signature():
    assert set(_entry_points()) == set(_build.SIGNATURES) | {"repro_error_string"}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_c_declaration(name):
    c_types = _entry_points()[name]
    assert len(_build.SIGNATURES[name]) == len(c_types)
    assert _build.SIGNATURES[name] == c_types


@pytest.mark.parametrize("flags", ["NVCC_FLAGS", "LINK_FLAGS"])
def test_digest_changes_with_every_flag(flags, monkeypatch):
    before = _build._digest()
    monkeypatch.setattr(_build, flags, getattr(_build, flags) + ["-DREPRO_TEST_FLAG"])
    assert _build._digest() != before


@pytest.mark.parametrize("header", ["common.cuh", "hopper.cuh", "tf32.cuh"])
def test_digest_changes_with_every_header(header, tmp_path, monkeypatch):
    for p in _build.CSRC.glob("*.cu*"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    with open(tmp_path / header, "a") as f:
        f.write("\n// edited\n")
    assert _build._digest() != before
