"""GPipe in the port (``distributed/pipeline.py``) on ``["cpu"] * S``
meshes: the pipelined outputs are the per-microbatch loop's bit for bit,
the gradients within 1e-5 of it, with and without ``remat``. JAX's
``gpipe_apply`` on 4 host devices is held against the port in the
subprocess of ``tests/test_torch_sharding.py``."""
import pytest
import torch

from repro_torch.distributed.pipeline import gpipe_apply, stack_stage_params
from repro_torch.launch.mesh import make_mesh

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stage_fn(p, x):
    """``tests/test_distributed.py``'s stage."""
    return torch.tanh(x @ p["w"] + p["b"])


def init_stage(g, dev):
    return {"w": (torch.randn(16, 16, generator=g, device=dev) * 0.5
                  ).requires_grad_(),
            "b": (torch.randn(16, generator=g, device=dev) * 0.1
                  ).requires_grad_()}


def _loop(params, xm):
    """Each microbatch through every stage in turn."""
    outs = []
    for i in range(xm.shape[0]):
        r = xm[i]
        for p in params:
            r = stage_fn(p, r)
        outs.append(r)
    return torch.stack(outs)


def _grads(out, params):
    leaves = [p[k] for p in params for k in ("w", "b")]
    return torch.autograd.grad((out ** 2).sum(), leaves)


@pytest.mark.parametrize("n_micro", [1, 4, 6])
@pytest.mark.parametrize("n_stages", [4, 8])
def test_gpipe_matches_loop(n_stages, n_micro):
    mesh = make_mesh((n_stages,), ("pod",), [CPU] * n_stages)
    params = stack_stage_params(init_stage, 0, n_stages, mesh=mesh)
    xm = torch.randn(n_micro, 6, 16, generator=torch.Generator()
                     .manual_seed(5))
    ref = _loop(params, xm)
    want = _grads(ref, params)
    by_remat = {}
    for remat in (True, False):
        outs = gpipe_apply(stage_fn, params, xm, mesh=mesh, n_micro=n_micro,
                           remat=remat)
        assert len(outs) == n_stages
        for o in outs:  # one copy a stage, each the loop's bit for bit
            assert torch.equal(o, ref)
        got = _grads(outs[-1], params)
        assert max(float((a - b).abs().max())
                   for a, b in zip(got, want)) <= 1e-5
        by_remat[remat] = got
    assert max(float((a - b).abs().max())
               for a, b in zip(*by_remat.values())) <= 1e-5


def test_stack_stage_params_draws_a_generator_a_stage():
    """Stage s draws from its own generator (seed + s): two stacks from
    one seed are equal, the stages differ, and each sits on its stage's
    device; a stage count other than the mesh's raises."""
    mesh = make_mesh((4,), ("pod",), [CPU] * 4)
    a = stack_stage_params(init_stage, 3, 4, mesh=mesh)
    b = stack_stage_params(init_stage, 3, 4, mesh=mesh)
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["w"], a[1]["w"])
    g = torch.Generator().manual_seed(3 + 2)
    assert torch.equal(a[2]["w"], init_stage(g, CPU)["w"])
    with pytest.raises(ValueError, match="3 stages"):
        gpipe_apply(stage_fn, a[:3], torch.zeros(2, 1, 16), mesh=mesh,
                    n_micro=2)
