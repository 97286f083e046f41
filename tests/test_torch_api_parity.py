"""The port does all that the JAX package does: a walk of every module of
``professad_tpu`` against the matching module of ``professad_tpu_torch``.

For each JAX module the walk takes its public names (``__all__``, or else
the public functions and classes defined in it), each public method of
each public class, and every parameter name of each (``inspect.signature``).
Each item needs a counterpart in the port, where ``ops.pallas_fft`` maps
to ``ops.spectral_conv`` and the parameter ``axis_name`` to ``group``, or
an entry in ``NOT_PORTED`` with its reason.  The check runs both ways: an
entry whose item the port has, or whose item the JAX package lacks, fails
too, so the table cannot go stale.  It only imports modules.
"""

import importlib
import inspect
import pkgutil
import textwrap
import types

import pytest

import professad_tpu

MODULE_MAP = {"ops.pallas_fft": "ops.spectral_conv"}
PARAM_MAP = {"axis_name": "group"}

_F64_TIER = ("the TPU's f64 workaround (no f64 FFT and no complex128 on the "
             "TPU); cuFFT has f64 transforms, so the port has none")
_FFT_MODE = ("a switch between the TPU's transform tiers; the port calls "
             "B1 and torch.fft directly and keeps torch.fft as B1's oracle")
_A1 = ("ROADMAP A1: on the H100 the f32 bias of torch.pow / torch.log is "
       "at most 2.461 ueV/atom per term, so the TPU's pow/log/exp "
       "replacements are not ported")
_INTERPRET = ("Pallas interpret mode (a TPU kernel run on the CPU); a port "
              "kernel runs its plain version for CPU tensors and has no "
              "interpreter")
_FREEZE = ("a jax.vmap workaround: under vmap lax.while_loop runs the body "
           "for every lane until all stop; the port's *_minimize_lanes "
           "solvers freeze stopped lanes themselves")

# (module, item) -> reason.  An item is a name, "Class.method", a
# "name(param)", or "*" for the whole module.
NOT_PORTED = {
    ("ops.tpufft", "*"): _F64_TIER + " (the MXU matmul DFT pair tier)",
    ("ops.grid", "Spectrum"): _F64_TIER + " (the (re, im) spectrum)",
    ("ops.grid", "set_fft_mode"): _FFT_MODE,
    ("ops.grid", "get_fft_mode"): _FFT_MODE,
    ("ops.grid", "set_conv_mode"): _FFT_MODE + " (outside __all__)",
    ("ops.grid", "powr"): _A1,
    ("ops.grid", "log_hp"): _A1,
    ("ops.grid", "exp_hp"): _A1,
    ("ops.pallas_fft", "spectral_conv_available"): (
        "whether jax.experimental.pallas imports; the port builds its "
        "kernel at the first CUDA call and raises if nvcc is missing"),
    ("ops.pallas_fft", "spectral_conv(interpret)"): _INTERPRET,
    ("ops.solvers", "tpgd_minimize(freeze_lanes)"): _FREEZE,
    ("ops.solvers", "lbfgs_minimize(freeze_lanes)"): _FREEZE,
    ("parallel.pfft", "make_penergy"): (
        "a shard_map + jit wrapper of a term body; the port's bodies run "
        "as they stand on every rank under ops.grid.pencil_mode"),
    ("parallel.pfft", "pencil_tpgd_minimize(axis_name)"): (
        "names the mesh axis to shard over; the port's mesh has the fixed "
        "axes ('batch', 'grid') and takes the grid group from the mesh"),
    ("parallel.mesh", "make_mesh(devices)"): (
        "one process per device: the process group is the device list, so "
        "cards are chosen by torchrun / CUDA_VISIBLE_DEVICES"),
    ("parallel", "make_mesh(devices)"): (
        "the re-export of parallel.mesh.make_mesh, same reason"),
    ("utils.profiling", "trace(create_perfetto_link)"): (
        "a hook of jax.profiler's local UI; the port's Chrome trace opens "
        "in Perfetto as it is"),
    ("models.ions", "_spread_mxu"): (
        "the matmul form of the PME spread, built for the TPU's MXU; every "
        "method runs the scatter (one index_add) in the port"),
    ("system", "System._spectral_precond"): (
        "unused in the JAX package, kept there only for comparison"),
}
NOT_PORTED.update({
    ("ops.vpufft", f"{name}(interpret)"): _INTERPRET
    for name in ("fft_sublane", "ifft_sublane", "fft_sublane_real",
                 "ifft_sublane_real_out", "sublane_conv", "fft_mid",
                 "ifft_mid", "conv3_bfly")})


def _public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items() if not n.startswith("_")
                 and (inspect.isfunction(v) or inspect.isclass(v))
                 and v.__module__ == mod.__name__]
    return sorted(names)


def _params(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [p for p in sig.parameters if p not in ("self", "cls")]


def _resolve(mod, name):
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def walk(mod):
    """The items of ``mod``: each public name, each public method of a
    public class ("Class.method") and each parameter ("name(param)")."""
    items = []
    for name in _public_names(mod):
        obj = getattr(mod, name)
        items.append(name)
        targets = [name] if callable(obj) else []
        if inspect.isclass(obj):
            methods = [f"{name}.{m}" for m, v in vars(obj).items()
                       if not m.startswith("_")
                       and inspect.isfunction(getattr(v, "__func__", v))]
            items += methods
            targets += methods
        for target in targets:
            items += [f"{target}({p})"
                      for p in _params(_resolve(mod, target)) or ()]
    return items


def has(mod, item):
    """Whether ``mod`` has ``item``, a parameter under its mapped name."""
    if mod is None:
        return False
    if item == "*":
        return True
    name, _, param = item.partition("(")
    obj = _resolve(mod, name)
    if obj is None or not param:
        return obj is not None
    params = _params(obj) or ()
    param = param[:-1]
    return param in params or PARAM_MAP.get(param) in params


def gaps(jmod, tmod, table):
    """(items missing from the port without an entry, entries whose item
    the port has or the JAX module lacks); ``tmod`` None: no such module."""
    missing = []
    if tmod is None:
        if "*" not in table:
            missing.append("*")
    else:
        for item in walk(jmod):
            # an entry for a name covers its methods and parameters
            name = item.partition("(")[0]
            if not has(tmod, item) and not {
                    item, name, name.split(".")[0]} & set(table):
                missing.append(item)
    stale = [item for item in table
             if has(tmod, item) or not has(jmod, item)]
    return missing, stale


def _jax_modules():
    return [info.name[len("professad_tpu."):] for info in
            pkgutil.walk_packages(professad_tpu.__path__, "professad_tpu.")]


JAX_MODULES = _jax_modules()


def _port(rel):
    try:
        return importlib.import_module(
            "professad_tpu_torch." + MODULE_MAP.get(rel, rel))
    except ModuleNotFoundError:
        return None


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_is_ported(rel):
    jmod = importlib.import_module("professad_tpu." + rel)
    table = {item: why for (m, item), why in NOT_PORTED.items() if m == rel}
    assert all(why.strip() for why in table.values())
    missing, stale = gaps(jmod, _port(rel), table)
    assert not missing, f"no counterpart and no NOT_PORTED entry: {missing}"
    assert not stale, f"NOT_PORTED entries the port has or JAX lacks: {stale}"


def test_table_names_walked_modules():
    assert {m for m, _ in NOT_PORTED} <= set(JAX_MODULES)
    assert len(JAX_MODULES) > 30


def _fake(name, source):
    mod = types.ModuleType(name)
    exec(textwrap.dedent(source), mod.__dict__)
    return mod


def test_walker_catches_a_missing_keyword():
    """A fake module pair: the port's ``f`` lacks the keyword ``k`` and its
    ``C.m`` the keyword ``interpret``; ``axis_name`` maps to ``group``."""
    jmod = _fake("fake_jax", """
        def f(x, axis_name=None, k=1):
            pass
        class C:
            def m(self, y, interpret=False):
                pass
        def _private(z):
            pass
        """)
    tmod = _fake("fake_port", """
        def f(x, group=None):
            pass
        class C:
            def m(self, y):
                pass
        """)
    assert walk(jmod) == ["C", "C.m", "C.m(y)", "C.m(interpret)", "f",
                          "f(x)", "f(axis_name)", "f(k)"]
    assert gaps(jmod, tmod, {}) == (["C.m(interpret)", "f(k)"], [])
    why = {"C.m(interpret)": "interpret mode"}
    assert gaps(jmod, tmod, why) == (["f(k)"], [])
    # an entry for an item the port has, or the JAX module lacks, is stale
    assert gaps(jmod, tmod, {**why, "f(k)": "-", "f(x)": "-",
                             "g": "-"}) == ([], ["f(x)", "g"])
    assert gaps(jmod, None, {}) == (["*"], [])
