"""PyTorch port vs the JAX package: the stream probe (kernel K5).

The twin `probe.stream_probe_plain` against the Pallas `null_kernel` of
`benchmarks/launch_overhead_exp.py`, run in interpret mode. That module
runs its sweep on import, so its kernel body and its `pallas_call` are
rebuilt here. The CUDA kernel itself is compared with its twin by the
`cuda`-marked test at the end (skipped without a GPU) and by
`chip_smoke.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pose_estimation_tpu_torch.ops import probe  # noqa: E402

W = probe.WIDTH


def _null_kernel(pp_ref, img_ref, out_ref):
    out_ref[:, :] = img_ref[0, 0:8, 0:128].astype(jnp.float32) * 2.0


def _pallas_probe(stack, pp):
    n_progs, h = len(pp), stack.shape[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(n_progs,),
        in_specs=[pl.BlockSpec((1, h, W), lambda g, pp_: (pp_[g], 0, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda g, pp_: (g, 0)),
    )
    return pl.pallas_call(
        _null_kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((8 * n_progs, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(pp), stack)


def _inputs(dtype):
    rng = np.random.default_rng(0)
    stack = rng.uniform(0, 255, (5, 16, W)).astype(np.float32)
    pp = np.array([0, 0, 3, 4, 4, 1, 2], np.int32)      # repeats and any order
    jstack = jnp.asarray(stack).astype(dtype)
    # the same rounded values on both sides
    tstack = torch.from_numpy(np.array(jstack.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        tstack = tstack.to(torch.bfloat16)
    return jstack, tstack, pp


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_stream_probe_plain_equals_pallas_interpret(dtype):
    """Exact: a doubling of values that float32 holds."""
    jstack, tstack, pp = _inputs(dtype)
    ref = np.asarray(_pallas_probe(jstack, pp))
    got = probe.stream_probe_plain(tstack, torch.from_numpy(pp))
    assert got.dtype == torch.float32 and got.shape == (8 * len(pp), 128)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_stream_probe_on_cpu_runs_the_twin():
    _, tstack, pp = _inputs(jnp.float32)
    before = probe.stream_probe.launches
    got = probe.stream_probe(tstack, torch.from_numpy(pp))
    assert probe.stream_probe.launches == before
    assert torch.equal(got, probe.stream_probe_plain(tstack, torch.from_numpy(pp)))
    with pytest.raises(ValueError, match="CUDA"):
        probe.sweep("cpu")


# ---- on the card: the CUDA kernel against its twin (skipped without a GPU)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stream_probe_kernel_equals_twin_on_gpu(gpu, dtype):
    gen = torch.Generator(device=gpu).manual_seed(0)
    stack = (torch.rand((32, 120, W), generator=gen, device=gpu) * 255).to(dtype)
    pp = torch.arange(32, dtype=torch.int32, device=gpu).repeat_interleave(2)
    before = probe.stream_probe.launches
    got = probe.stream_probe(stack, pp)
    torch.cuda.synchronize()
    assert probe.stream_probe.launches == before + 1
    assert torch.equal(got, probe.stream_probe_plain(stack, pp))
