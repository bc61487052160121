"""The port's instance builders against the JAX package's: catalog,
scenario windows, config grids and padded stacks must be bit-equal, since
both run numpy's RNG on the same configs (tolerance: none, exact)."""
import numpy as np
import pytest
import torch

from repro.core import lp as LP
from repro.experiments import sweep as SW
from repro.mec import catalog as CAT
from repro.mec import scenario as SC
from repro_torch.core import lp as TLP
from repro_torch.experiments import sweep as TSW
from repro_torch.mec import catalog as TCAT
from repro_torch.mec import scenario as TSC


def _inst_fields(inst):
    return {k: getattr(inst, k) for k in inst.__dataclass_fields__}


def _assert_inst_equal(a, b):
    fa, fb = _inst_fields(a), _inst_fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k


@pytest.mark.parametrize("n_models,seed", [(8, 7), (4, 3), (2, 11)])
def test_paper_catalog_bit_equal(n_models, seed):
    ref = CAT.make_catalog("paper", n_models=n_models, seed=seed)
    got = TCAT.make_catalog("paper", n_models=n_models, seed=seed)
    for k in ("sizes", "prec", "flops", "loadD"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    assert (got.names, got.n_models, got.H) == (ref.names, ref.n_models,
                                                 ref.H)
    assert got.load_seconds(0, 0, 3) == ref.load_seconds(0, 0, 3)


@pytest.mark.parametrize("source", ["zoo", "measured", "nope"])
def test_unported_catalog_sources_raise(source):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TCAT.make_catalog(source)


def test_default_axes_and_config_grid_match():
    assert TSW.DEFAULT_AXES == SW.DEFAULT_AXES
    base = TSC.MECConfig(n_users=40)
    ref = SC.config_grid(SC.MECConfig(n_users=40), SW.DEFAULT_AXES)
    got = TSC.config_grid(base, TSW.DEFAULT_AXES)
    assert [vars(c) for c in got] == [vars(c) for c in ref]


@pytest.mark.parametrize("n_users", [40, 600])
def test_sweep_windows_bit_equal(n_users):
    """Every window of the 16-variant DEFAULT_AXES grid, and the padded
    stack built from them, equal the reference's bit for bit."""
    base = SC.MECConfig(n_users=n_users)
    ref_insts = [SC.Scenario(c).instance(0, SC.Scenario(c).empty_cache())
                 for c in SC.config_grid(base, SW.DEFAULT_AXES)]
    cfgs, insts = TSW.sweep_instances(TSC.MECConfig(n_users=n_users))
    assert len(insts) == len(ref_insts) == 16
    for a, b in zip(insts, ref_insts):
        _assert_inst_equal(a, b)
    ref = SC.stack_instances(ref_insts)
    got = TSC.stack_instances(insts, device="cpu")
    assert tuple(got.data.T.shape) == ref.data.T.shape == (16, 6, n_users, 3)
    np.testing.assert_array_equal(got.n_bs, ref.n_bs)
    np.testing.assert_array_equal(got.n_users, ref.n_users)
    for k in LP.PDHGData._fields:
        v = getattr(got.data, k)
        assert v.dtype == torch.float64 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), getattr(ref.data, k),
                                      err_msg=k)


def test_hetero_stack_pad_to_and_unstack():
    spec = [(0, 40, 3), (1, 50, 4), (2, 35, 3)]
    ref_insts = [SC.Scenario(SC.MECConfig(n_bs=n, n_users=u, n_models=4,
                                          seed=s)) for s, u, n in spec]
    ref_insts = [sc.instance(0, sc.empty_cache()) for sc in ref_insts]
    insts = [TSC.Scenario(TSC.MECConfig(n_bs=n, n_users=u, n_models=4,
                                        seed=s)) for s, u, n in spec]
    insts = [sc.instance(0, sc.empty_cache()) for sc in insts]
    ref = SC.stack_instances(ref_insts, pad_to=(5, 64))
    got = TSC.stack_instances(insts, pad_to=(5, 64), device="cpu")
    for k in LP.PDHGData._fields:
        np.testing.assert_array_equal(getattr(got.data, k).numpy(),
                                      getattr(ref.data, k), err_msg=k)
    rng = np.random.default_rng(0)
    x = rng.random((3, 5, 4, 4))
    A = rng.random((3, 5, 64, 3))
    for (xa, Aa), (xb, Ab) in zip(got.unstack(torch.from_numpy(x),
                                              torch.from_numpy(A)),
                                  ref.unstack(x, A)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(Aa, Ab)
    with pytest.raises(ValueError, match="smaller"):
        TSC.stack_instances(insts, pad_to=(2, 10), device="cpu")


def test_pdhg_data_from_numpy_carries_reference_fields():
    """The reference's PDHGData (or a dict of its fields) becomes the
    port's float64 tensors unchanged."""
    sc = SC.Scenario(SC.MECConfig(n_users=30, n_bs=3, n_models=4, seed=5))
    ref = LP.pdhg_data(sc.instance(0, sc.empty_cache()))
    for src in (ref, ref._asdict()):
        got = TLP.pdhg_data_from_numpy(src, device="cpu")
        for k in LP.PDHGData._fields:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          getattr(ref, k), err_msg=k)
    tsc = TSC.Scenario(TSC.MECConfig(n_users=30, n_bs=3, n_models=4, seed=5))
    one = TLP.pdhg_data(tsc.instance(0, tsc.empty_cache()), device="cpu")
    for k in LP.PDHGData._fields:
        np.testing.assert_array_equal(getattr(one, k)[0].numpy(),
                                      getattr(ref, k), err_msg=k)


def test_entry_points_default_to_cuda_and_never_fall_back():
    """device defaults to "cuda": without a card every entry point raises
    instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract is moot")
    sc = TSC.Scenario(TSC.MECConfig(n_users=10, n_bs=2, n_models=2))
    inst = sc.instance(0, sc.empty_cache())
    for call in (lambda: TLP.pdhg_data(inst),
                 lambda: TSC.stack_instances([inst]),
                 lambda: TLP.solve_lp_pdhg(inst, iters=2),
                 lambda: TSW.run_sweep(pdhg_iters=2, best_of=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
