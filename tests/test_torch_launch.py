"""The one launch path of the port's kernels (cdk_torch/core/build.py) on
the CPU: every entry point of csrc/*.cu typed from its own declaration,
every entry name a module launches declared there, the mapping of a
launch's arguments to ctypes, and the parser on made-up sources.  The
launch itself runs on the card (tests/test_torch_gpu.py); its counting is
held in tests/test_torch_trace.py.  Needs no jax and no nvcc."""

import ast
import ctypes
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from cdk_torch.core import build

ROOT = Path(__file__).resolve().parents[1]
# each entry's parameters as the wrappers pass them: P a pointer (const
# void* or void*), I int, F float, D double, L long long
EXPECTED = {
    "cdk_bd8_resident_f32": "PPPIIIIIP",
    "cdk_bd8_resident_f64": "PPPIIIIP",
    "cdk_biharmonic_fused": "PPPPIIFIP",
    "cdk_cke_group_f32": "PPPPPPPPPPIIIIIIIDP",
    "cdk_cke_group_f64": "PPPPPPPPPPIIIIIIIDP",
    "cdk_cke_lanegather_f32": "PPPPPPPPIIIIDP",
    "cdk_cke_lanegather_f64": "PPPPPPPPIIIIDP",
    "cdk_cke_onehot_f32": "PPPPPPPIIIIDIP",
    "cdk_cke_onehot_f64": "PPPPPPPIIIIDP",
    "cdk_cke_rows_f32": "PPPPPPPIIIIDP",
    "cdk_cke_rows_f64": "PPPPPPPIIIIDP",
    "cdk_cke_staged_f32": "PPPPPPIIIDP",
    "cdk_cke_staged_f64": "PPPPPPIIIDP",
    "cdk_dss2d_resident_f32": "PPPPIIIIIP",
    "cdk_dss_cube_f32": "PPPPPIIP",
    "cdk_dss2d_resident_f64": "PPPPIIIIP",
    "cdk_dss_resident_f32": "PPPPPIIIIIP",
    "cdk_dss_resident_f64": "PPPPPIIIIP",
    "cdk_dss_resident_window_f32": "PPPPPPPIIIIIIP",
    "cdk_dss_resident_window_f64": "PPPPPPPIIIIIP",
    "cdk_l2_read_probe": "PLIIPP",
    "cdk_mpdata_lanes_f32": "PPPPPPPPPIIIIP",
    "cdk_mpdata_lanes_f64": "PPPPPPPPPIIIIP",
    "cdk_mpdata_masked_f32": "P" * 11 + "I" * 11 + "P",
    "cdk_mpdata_masked_f64": "P" * 11 + "I" * 11 + "P",
    "cdk_mpdata_max_levels": "",
    "cdk_mpdata_resident_f32": "PPPPPPPPPIIIIIP",
    "cdk_mpdata_resident_f64": "PPPPPPPPPIIIIIP",
    "cdk_mpdata_staged_bf16": "PPPPPPPPPIIIIIP",
    "cdk_mpdata_staged_f32": "PPPPPPPPPIIIIIP",
    "cdk_mpdata_staged_f64": "PPPPPPPPPIIIIIP",
    "cdk_rowchain_f32": "IPPPPPIIIIIIIIIP",
    "cdk_rowchain_f64": "IPPPPPIIIIIIIIP",
}
LETTER = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float,
          "D": ctypes.c_double, "L": ctypes.c_longlong}
# entries called for a value, not launched
NOT_LAUNCHED = {"cdk_mpdata_max_levels"}


def _module_dicts(tree: ast.Module) -> dict:
    """Module-level `NAME = {...}` tables."""
    return {t.id: node.value for node in tree.body if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Dict) for t in node.targets
            if isinstance(t, ast.Name)}


def _strings(node) -> set:
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _launch_sites() -> dict:
    """Every `build.launch(...)` call of the port and of chip_smoke.py ->
    the entry names its entry argument can take: the strings in it, or in
    the module's dict it indexes."""
    sites = {}
    for path in sorted((ROOT / "cdk_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        tables = _module_dicts(tree)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "build"):
                continue
            entry = node.args[3]
            names = _strings(entry)
            if isinstance(entry, ast.Subscript) and isinstance(entry.value, ast.Name):
                names |= {v.value for v in tables[entry.value.id].values
                          if isinstance(v, ast.Constant)}
            sites[f"{path.relative_to(ROOT)}:{node.lineno}"] = names
    return sites


SITES = _launch_sites()


@pytest.mark.parametrize("name", sorted(set(EXPECTED) | set(build.declarations())))
def test_entry_parses_to_its_types(name):
    """Each entry point of csrc/*.cu is declared once, with the parameter
    types its wrapper passes, and returns int."""
    decl = build.declarations()
    assert name in decl, f"{name} is not defined in csrc/"
    assert name in EXPECTED, f"{name} has no expected types here"
    assert decl[name] == tuple(LETTER[c] for c in EXPECTED[name])
    assert name in NOT_LAUNCHED or any(name in names for names in SITES.values()), (
        f"no module launches {name}")


@pytest.mark.parametrize("site", sorted(SITES))
def test_launched_entry_is_declared(site):
    names = SITES[site]
    assert names, f"{site}: its entry name is not a string or a module table"
    assert names <= set(build.declarations()), names - set(build.declarations())


def test_every_kernel_module_launches_through_build():
    """Each module with a kernel wrapper, and chip_smoke.py's probe,
    launches through `build.launch`, and no other module does."""
    kernels = "cdk_torch/kernels/"
    assert {s.split(":")[0] for s in SITES} == {
        "chip_smoke.py",
        *(kernels + f"biharmonic/{m}.py" for m in (
            "resident", "fused", "dss_resident", "dss2d_resident",
            "dss2d_rowchain", "dss_cube")),
        *(kernels + f"mpdata/{m}.py" for m in ("launch", "lanes", "masked")),
        *(kernels + f"cke/{m}.py" for m in ("rows", "group", "staged",
                                            "onehot", "lanegather"))}


def test_c_args_maps_tensors_to_pointers_and_none_to_null():
    """At the pointer positions a tensor becomes its data pointer and None
    stays None (NULL); a number elsewhere passes as it is, as ctypes then
    hands them to an entry of those types."""
    t = torch.arange(6.0).reshape(2, 3)
    view = t[1]
    out = build.c_args((0, 1, 2), (t, None, view, 3, 2.5, True))
    assert out == [t.data_ptr(), None, view.data_ptr(), 3, 2.5, True]
    assert view.data_ptr() == t.data_ptr() + 3 * t.element_size()
    # an entry typed (int, void*, void*, double, void*), the stream last
    seen = []
    P = ctypes.c_void_p
    fn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, P, P, ctypes.c_double, P)(
        lambda *a: seen.append(a) or 0)
    assert fn(*build.c_args((1, 2), (7, t, None, 0.5)), 12345) == 0
    assert seen == [(7, t.data_ptr(), None, 0.5, 12345)]


def test_library_binds_each_entry_with_its_pointer_positions(monkeypatch, tmp_path):
    """`library()` loads the built library once, sets each entry's argtypes
    and restype from its declaration and keeps the positions of its
    pointer parameters, the stream left out."""
    class Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = SimpleNamespace(name=name)
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "build", lambda: build.Built(tmp_path / "x.so", 0.0, ""))
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    build.library.cache_clear()
    try:
        lib = build.library()
        assert set(lib) == set(EXPECTED)
        for name, (fn, pointers) in lib.items():
            assert fn.name == name and fn.restype is ctypes.c_int
            assert fn.argtypes == tuple(LETTER[c] for c in EXPECTED[name])
            assert pointers == tuple(i for i, c in enumerate(EXPECTED[name][:-1])
                                     if c == "P")
        assert lib["cdk_rowchain_f32"][1] == (1, 2, 3, 4, 5)
        assert lib["cdk_mpdata_max_levels"][1] == ()
    finally:
        build.library.cache_clear()


def test_parser_reads_definitions_macros_and_refuses_other_types():
    src = """
    // int cdk_commented(int x) {
    /* int cdk_blocked(float y) { */
    extern "C" {
    int cdk_a(const void* x, void *y, int n, float r, double c,
              long long m, void* stream) {
      return 0;
    }
    int cdk_none() { return 7; }
    int cdk_void(void) { return 7; }
    #define ENTRY(name, T)                                  \\
      int name(const void* f, void* out, int n, void* stream) { \\
        return go<T>(f, out, n, stream);                    \\
      }
    ENTRY(cdk_m_f32, float)
    ENTRY(cdk_m_f64, double)
    }
    """
    P, I = ctypes.c_void_p, ctypes.c_int
    assert build.parse_declarations(src) == {
        "cdk_a": (P, P, I, ctypes.c_float, ctypes.c_double, ctypes.c_longlong, P),
        "cdk_none": (), "cdk_void": (),
        "cdk_m_f32": (P, P, I, P), "cdk_m_f64": (P, P, I, P)}
    with pytest.raises(TypeError, match="cdk_b: parameter 'const float\\* x'"):
        build.parse_declarations("int cdk_b(const float* x, void* s) { }")
    with pytest.raises(TypeError, match="unsigned n"):
        build.parse_declarations("int cdk_c(unsigned n) { }")
