"""The port's debug and profiling utilities (``vaemolsim_tpu_torch/utils/
debug.py``, ``profiling.py``) against the JAX package's
(``vaemolsim_tpu/utils``): ``checked`` names the op and the line that
made a NaN, indexed out of bounds or divided an integer by zero (the
counterparts of checkify's float, index and div checks); the eager
guards; ``StepTimer`` and ``benchmark_fn``; ``count_params`` equal to
JAX's for the flagship VAE.
"""

import json
import os

import jax.numpy as jnp
import pytest
import torch

from vaemolsim_tpu.config import flagship_experiment_config as jflagship
from vaemolsim_tpu.utils import count_params as jcount
from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.config import flagship_experiment_config
from vaemolsim_tpu_torch.utils import (CheckError, StepTimer, assert_finite,
                                       assert_shape, benchmark_fn, checked,
                                       count_params, trace)

THIS = os.path.basename(__file__)


def test_checked_names_the_op_that_made_a_nan():
    def fn(x):
        y = x * 2.0
        return torch.log(y - 5.0)

    with pytest.raises(CheckError, match=r"NaN produced in aten\.log") as e:
        checked(fn)(torch.ones(3))
    assert THIS in str(e.value) and "torch.log" in str(e.value)
    torch.testing.assert_close(checked(fn)(torch.full((2,), 4.0)),
                               torch.log(torch.full((2,), 3.0)))


@pytest.mark.parametrize("how", ["getitem", "index_select", "gather"])
def test_checked_names_an_out_of_bounds_index(how):
    x, i = torch.arange(4.0), torch.tensor([1, 4])
    fns = {"getitem": lambda: x[i],
           "index_select": lambda: torch.index_select(x, 0, i),
           "gather": lambda: torch.gather(x, 0, i)}
    with pytest.raises(CheckError, match="index out of bounds") as e:
        checked(fns[how])()
    assert THIS in str(e.value)


def test_checked_names_an_integer_division_by_zero():
    a, b = torch.tensor([4, 6]), torch.tensor([2, 0])
    with pytest.raises(CheckError, match="integer division by zero") as e:
        checked(lambda: a // b)()
    assert "floor_divide" in str(e.value)
    # float division by zero is inf, not an error (as checkify's div
    # checks, which are integer-only)
    assert torch.isinf(checked(lambda: 1.0 / torch.zeros(1))()).all()


def test_checked_reads_what_a_kernel_launch_writes():
    """The kernels bypass the dispatcher: checked reads the outputs each
    launch hands to _build.LAUNCH_HOOKS."""

    class Fake:
        name, source = "dense_stack", "csrc/dense_stack.cu"

    made = torch.tensor([1.0, float("nan")])

    def fn():
        out = made  # written by a launch: no op the dispatcher saw
        for hook in _build.LAUNCH_HOOKS:
            hook(Fake(), (out,))
        return out

    with pytest.raises(CheckError, match="dense_stack kernel"):
        checked(fn)()
    assert not _build.LAUNCH_HOOKS
    fn()  # no hook outside checked


def test_user_errors_pass_through():
    def fn():
        raise ValueError("user check")

    with pytest.raises(ValueError, match="user check"):
        checked(fn)()


def test_assert_finite_and_shape():
    assert_finite({"a": torch.ones(2), "b": [torch.zeros(3)]})
    with pytest.raises(AssertionError, match="bad: leaf 1"):
        assert_finite([torch.ones(1), torch.tensor([float("inf")])], "bad")
    assert_shape(torch.zeros(2, 3), (2, 3))
    assert_shape(torch.zeros(2, 3), (None, 3))
    with pytest.raises(AssertionError, match="w: expected shape"):
        assert_shape(torch.zeros(2, 3), (3, 2), "w")


def test_step_timer_and_benchmark_fn():
    timer = StepTimer()
    for _ in range(3):
        with timer.phase("mm") as ph:
            ph.result = {"y": torch.ones(64, 64) @ torch.ones(64, 64)}
    assert len(timer.times["mm"]) == 3
    assert timer.summary()["mm"] == pytest.approx(timer.mean("mm"))
    assert timer.mean("mm") > 0
    t = benchmark_fn(lambda a: a @ a, torch.ones(32, 32), warmup=2, iters=5)
    assert 0 < t < 1.0


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path)):
        (torch.ones(8) * 2).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_count_params_equals_jax_for_the_flagship():
    jvae = jflagship().build()
    vae = flagship_experiment_config().build("cpu")
    assert count_params(vae) == jcount(jvae)
    assert count_params({"w": torch.zeros(4, 4), "b": [torch.zeros(4)]}) == \
        jcount({"w": jnp.zeros((4, 4)), "b": [jnp.zeros(4)]})
