"""`pggan_tpu_torch/utils/debug.py` against `pggan_tpu/utils/debug.py` on the
same numpy inputs, on the CPU: `assert_shape`, `nan_to_num`,
`profiled_function`, `trace_context`, `copy_matching_leaves` and
`print_tree_summary` (the port names a tensor `a.b` where JAX has the
pytree path `['a']['b']`); and `check_replication_consistency` over two gloo
ranks (`parallel/dryrun.py:run_ranks`, bodies in tests/torch_rank_worker.py):
it passes on equal weights and names the weight whose last bit one rank
moved. No JAX program beyond eager `jnp` calls is compiled.
"""

import glob
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu.utils import debug as jax_debug
from pggan_tpu_torch.parallel import dryrun
from pggan_tpu_torch.utils import debug

RANK_TIMEOUT = 120


def _outcome(fn, *args):
    try:
        fn(*args)
        return "ok"
    except AssertionError as exc:
        return str(exc)


@pytest.mark.parametrize("shape, ref", [
    ((2, 3, 4), (2, None, 4)), ((2, 3, 4), (2, 3)), ((2, 3, 4), (2, 5, None)),
    ((5,), (None,)), ((), ())])
def test_assert_shape_matches_jax(shape, ref):
    x = np.zeros(shape, np.float32)
    assert _outcome(debug.assert_shape, torch.from_numpy(x), ref) == \
        _outcome(jax_debug.assert_shape, jnp.asarray(x), ref)


@pytest.mark.parametrize("kwargs", [{}, {"nan": 2.5, "posinf": 7.0, "neginf": -3.0}])
def test_nan_to_num_matches_jax(kwargs):
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    x[0, 0], x[1, 2], x[3, 4] = np.nan, np.inf, -np.inf
    np.testing.assert_array_equal(debug.nan_to_num(torch.from_numpy(x), **kwargs).numpy(),
                                  np.asarray(jax_debug.nan_to_num(jnp.asarray(x), **kwargs)))


def test_profiled_function_matches_jax_and_names_its_span():
    """The wrapped function returns what the function does in both packages,
    keeps its name, and shows as a span of that name in a profile."""
    def scaled_sum(x, k=2.0):
        return (x * k).sum()

    x = np.arange(6, dtype=np.float32)
    port, jaxed = debug.profiled_function(scaled_sum), jax_debug.profiled_function(scaled_sum)
    assert port.__name__ == jaxed.__name__ == "scaled_sum"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = port(torch.from_numpy(x), k=3.0)
    assert float(got) == float(jaxed(jnp.asarray(x), k=3.0)) == 45.0
    assert "scaled_sum" in {e.key for e in prof.key_averages()}


def test_trace_context_writes_a_trace(tmp_path):
    """Both write a trace of the block into the directory: the port a
    Chrome/TensorBoard `*.pt.trace.json`, JAX an XProf `*.xplane.pb`."""
    with debug.trace_context(str(tmp_path / "port")):
        torch.ones(8).add_(1)
    with jax_debug.trace_context(str(tmp_path / "jax")):
        jnp.ones(8).block_until_ready()
    assert glob.glob(str(tmp_path / "port" / "*.pt.trace.json"))
    assert glob.glob(str(tmp_path / "jax" / "**" / "*.xplane.pb"), recursive=True)


def _tree():
    rs = np.random.RandomState(1)
    return {"a": {"w": rs.randn(3, 2).astype(np.float32), "b": rs.randn(2).astype(np.float32)},
            "c": rs.randn(4).astype(np.float32)}


def _flat(tree, prefix=""):
    """A nested dict as a state dict: `a.w` for JAX's ['a']['w']."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


@pytest.mark.parametrize("require_all", [False, True])
def test_copy_matching_leaves_matches_jax(require_all):
    """Leaves that src has are replaced in dst's dtype; the others are
    kept, or raise KeyError with require_all; a shape mismatch raises."""
    dst = _tree()
    src = {"a": {"w": np.full((3, 2), 7.0, np.float64)}, "x": np.ones(3, np.float32)}
    port_dst = {k: torch.from_numpy(v) for k, v in _flat(dst).items()}
    outcomes = []
    for fn, d, s in ((jax_debug.copy_matching_leaves, dst, src),
                     (debug.copy_matching_leaves, port_dst, _flat(src))):
        try:
            out = _flat(fn(s, d, require_all=require_all))
            outcomes.append({k: (np.asarray(v).dtype, np.asarray(v).tolist())
                             for k, v in out.items()})
        except KeyError as exc:
            outcomes.append(("KeyError", exc.args[0].split("for ")[-1]))
    # JAX names a missing leaf by its path, the port by its state-dict name
    if require_all:
        assert outcomes == [("KeyError", "['a']['b']"), ("KeyError", "a.b")]
    else:
        assert outcomes[0] == outcomes[1]
        assert outcomes[1]["a.w"][1] == [[7.0, 7.0]] * 3
    with pytest.raises(ValueError, match="shape mismatch at a.w"):
        debug.copy_matching_leaves({"a.w": np.ones((2, 3))}, port_dst)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_debug.copy_matching_leaves({"a": {"w": np.ones((2, 3))}}, dst)


def test_print_tree_summary_matches_jax():
    """The same rows (shape and count per tensor), total and output shape
    line; only the names' notation differs."""
    tree = _tree()

    def apply_jax(params, x):
        return x @ params["a"]["w"]

    def apply_port(x):
        return x @ torch.from_numpy(tree["a"]["w"])

    x = np.ones((5, 3), np.float32)
    jax_text = jax_debug.print_tree_summary(tree, apply_jax, jnp.asarray(x), file=io.StringIO())
    port_text = debug.print_tree_summary({k: torch.from_numpy(v) for k, v in _flat(tree).items()},
                                         apply_port, torch.from_numpy(x), file=io.StringIO())

    def rows(text):
        """(shape, count) of each row, the header and the output line left out."""
        out = []
        for line in text.splitlines()[1:-1]:
            shape = re.search(r"\(.*?\)", line)
            out.append((shape.group(0) if shape else None, line.split()[-1]))
        return sorted(out, key=str)
    assert rows(port_text) == rows(jax_text)
    assert (None, "12") in rows(port_text)                      # the total
    assert port_text.splitlines()[-1] == jax_text.splitlines()[-1] == "output shape(s): (5, 2)"


@pytest.mark.parametrize("changed", ["", "blocks.0.conv1.weight"], ids=["equal", "one_bit"])
def test_check_replication_consistency_two_ranks(tmp_path, changed):
    """Two gloo ranks build the same G from one seed: the check passes on
    both; with one bit of one weight moved on rank 1, it raises on every
    rank naming that weight."""
    import torch_rank_worker

    dryrun.run_ranks(torch_rank_worker.replication_rank, 2, (str(tmp_path), changed),
                     store=str(tmp_path / "store"), timeout=RANK_TIMEOUT)
    results = [(tmp_path / f"rank{r}.txt").read_text() for r in range(2)]
    want = f"replication mismatch at G.{changed}: rank 0 vs 1" if changed else "ok"
    assert results == [want, want]


def test_check_replication_consistency_without_a_group():
    """Without a process group there is nothing to compare."""
    assert not torch.distributed.is_initialized()
    debug.check_replication_consistency(torch.nn.Linear(2, 3))
    debug.check_replication_consistency({"w": torch.ones(2), "none": None})
