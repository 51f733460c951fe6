"""The port's stage-1 training step vs the JAX ShapeTrainer step.

Both trainers start from the same parameters (the JAX ones carried over by
convert.params_from_jax) and the same occupancy state, take the same ray
batches (the RayBatcher copies draw from the same numpy seed) and the same
random draws: the port's sampler jitter, occ-loss scores and occ-update
jitter are drawn here with jax.random from the very keys the JAX trainer
splits.  The JAX step runs its stencil through the Pallas head in
interpret mode, the algorithm the port's stencil head reproduces.

Tolerances (float32 throughout): loss terms rtol 1e-4; every parameter
gradient within 1e-3 of its largest magnitude (grads pass through the
1/eps^2-amplified FD hessian and two differently ordered reductions);
parameters after Adam within 1e-6 absolute plus 1e-5 relative; the
3-step loss trace rtol 1e-3.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from tensoflow_tpu import config as jconfig
from tensoflow_tpu.fields import light as jlight
from tensoflow_tpu.models import shape_renderer as jsr
from tensoflow_tpu.train import losses as jlosses
from tensoflow_tpu.train.trainer import ShapeTrainer as JaxShapeTrainer
from tensoflow_tpu_torch import config as pconfig
from tensoflow_tpu_torch.convert import occ_state_from_jax, params_from_jax
from tensoflow_tpu_torch.train.trainer import ShapeTrainer, named_leaves

# one intra-op thread: the suite runs six workers on the CPU, and
# more threads each oversubscribe the cores and stall in their barriers
torch.set_num_threads(1)

OVERRIDES = [
    'database_name=toy/sphere_32_4', 'sdf_n_comp=4', 'sdf_dim=32',
    'app_dim=16', 'N_voxel_init=4096', 'N_voxel_final=4096',
    'occ_grid_reso=16', 'train_ray_num=64', 'occ_max_samples=48',
    'occ_loss_max_pn=64', 'upsample_list=null',
    'compact_samples_per_ray=16', 'name=parity']
CFG_PATH = 'configs/shape/syn/compressor_occ.yaml'


def _jax_trainer(extra=()):
    cfg = jconfig.load_config(CFG_PATH, overrides=OVERRIDES + list(extra)
                              + ['stencil_impl=pallas', 'stencil_tile=64'])
    t = JaxShapeTrainer(cfg)
    # geometric init zeroes W0's feature rows: noise them so the
    # gradients exercise the field path
    k = jax.random.PRNGKey(7)
    w0 = t.params['sdf']['mlp'][0]['w']
    t.params['sdf']['mlp'][0]['w'] = w0 + 0.05 * jax.random.normal(
        k, w0.shape)
    t.init_dataset()
    return t


class _JaxDrawsTrainer(ShapeTrainer):
    """The port's trainer drawing its noise from a JAX key chain that
    mirrors JaxShapeTrainer.train's splits."""

    def __init__(self, cfg, key, configure=None):
        super().__init__(cfg, device='cpu', configure=configure)
        self.key = key

    def occ_jitter(self, step):
        self.key, k = jax.random.split(self.key)
        r = self.occ_cfg.resolution
        return torch.from_numpy(np.asarray(
            jax.random.uniform(k, (r ** 3, 3))).copy())

    def step_noise(self, step):
        self.key, k = jax.random.split(self.key)
        k_sample, k_occ = jax.random.split(k)
        rn = self.cfg['train_ray_num']
        m = rn * self.rcfg.compact_samples_per_ray
        return {'sample_jitter': torch.from_numpy(np.asarray(
                    jax.random.uniform(k_sample, (rn, 1))).copy()),
                'occ_score': torch.from_numpy(np.asarray(
                    jax.random.uniform(k_occ, (m,))).copy())}


def _port_trainer(jt, extra=()):
    cfg = pconfig.load_config(CFG_PATH, overrides=OVERRIDES + list(extra))
    pt = _JaxDrawsTrainer(cfg, jt.rng)
    pt.set_params(params_from_jax(jax.tree.map(np.asarray, jt.params)))
    pt.occ_state = occ_state_from_jax(jax.tree.map(np.asarray, jt.occ_state))
    pt.init_dataset()
    return pt


def _jax_run(jt, n_steps):
    """n_steps of JaxShapeTrainer.train's loop, with the step's loss_fn
    (ShapeTrainer._get_step_fn) jitted once to also return the grads.
    Returns per-step (terms incl. 'loss', grads) and the params after the
    first Adam step."""
    jt.maybe_set_march_stride(0)
    rcfg = jt.rcfg

    @jax.jit
    def step_fn(params, opt_state, occ_state, batch, step, weights, k):
        def loss_fn(p):
            mips = jlight.build_mips(p['shading']['envlight'],
                                     rcfg.shading.env)
            out = jsr.train_step_outputs(p, rcfg, mips, occ_state, batch,
                                         step, k, False, True)
            total, terms = jlosses.total_loss_shape(out, weights)
            return total, {**terms, 'sample_num': out['sample_num']}

        (total, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = jt.tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state,
                {**terms, 'loss': total}, grads)

    runs, params1 = [], None
    for step in range(n_steps):
        jt.maybe_set_march_stride(step)
        if step % jt.occ_update_interval == 0:
            jt.rng, k = jax.random.split(jt.rng)
            jt.occ_state = jt._get_occ_update_fn(prune=False)(
                jt.params, jt.occ_state, step, k)
        batch = jt.batcher.next_batch()
        weights = jlosses.schedule_weights(jt.cfg, step)
        assert jt.phase_flags(step) == (False, True)
        jt.rng, k = jax.random.split(jt.rng)
        jt.params, jt.opt_state, terms, grads = step_fn(
            jt.params, jt.opt_state, jt.occ_state, batch, step, weights, k)
        runs.append(({k_: float(v) for k_, v in terms.items()},
                     _jax_leaves(grads)))
        jt.maybe_adapt_budget(step, terms)
        assert jt.rcfg == rcfg
        if step == 0:
            params1 = _jax_leaves(jt.params)
    return runs, params1


def _jax_leaves(tree):
    """{path tuple: numpy leaf}, paths as the port's named_leaves."""
    return {tuple(getattr(e, 'key', getattr(e, 'idx', None)) for e in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope='module')
def runs():
    """Three training steps of each trainer from the same state; for the
    port, the grads and params after the first step are kept."""
    jt = _jax_trainer()
    pt = _port_trainer(jt)
    jruns, jparams1 = _jax_run(jt, 3)
    plogs = pt.train(n_steps=1, log_every=1)
    leaves = named_leaves(pt.params)
    pgrads = {path: t.grad.clone().numpy() for path, t in leaves}
    pparams1 = {path: t.detach().clone().numpy() for path, t in leaves}
    plogs += pt.train(n_steps=2, log_every=1)
    return dict(jruns=jruns, jparams1=jparams1, plogs=plogs,
                pgrads=pgrads, pparams1=pparams1)


def test_step_loss_terms_match_jax(runs):
    j_terms, _ = runs['jruns'][0]
    p_terms = runs['plogs'][0]
    for k, v in j_terms.items():
        np.testing.assert_allclose(p_terms[k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_step_grads_match_jax(runs):
    _, j_grads = runs['jruns'][0]
    p_grads = runs['pgrads']
    assert sorted(j_grads) == sorted(p_grads)
    for path, jg in j_grads.items():
        scale = float(np.abs(jg).max()) + 1e-12
        np.testing.assert_allclose(p_grads[path] / scale, jg / scale,
                                   atol=1e-3, err_msg=f'grad {path}')


def test_step_adam_params_match_jax(runs):
    for path, jp in runs['jparams1'].items():
        np.testing.assert_allclose(runs['pparams1'][path], jp, rtol=1e-5,
                                   atol=1e-6, err_msg=f'param {path}')


def test_three_step_loss_trace_matches_jax(runs):
    assert [l['step'] for l in runs['plogs']] == [1, 2, 3]
    for step, ((jt, _), pl) in enumerate(zip(runs['jruns'], runs['plogs'])):
        for k in ('loss', 'loss_rgb', 'loss_eikonal', 'loss_mask',
                  'loss_occ', 'sample_num'):
            np.testing.assert_allclose(pl[k], jt[k], rtol=1e-3, atol=1e-7,
                                       err_msg=f'step {step} {k}')


# NeuS's published SDF network (confs/womask.conf: multires 6, a 256-wide
# feature) on the port's widths: E = 3 + 6*6 = 39 PE columns and an
# appearance head of O = 1 + 256 columns, past what the fast stencil
# kernels are built for (the general kernels take them on the card)
NEUS_WIDTHS = ['sdf_multires=6', 'app_dim=256']


def test_step_at_neus_widths_matches_jax():
    """One training step at the NeuS widths (narrow C and H): loss terms
    and every parameter gradient against the JAX step, at the tolerances
    of the module docstring."""
    from tensoflow_tpu_torch.ops import stencil as pst
    jt = _jax_trainer(NEUS_WIDTHS)
    pt = _port_trainer(jt, NEUS_WIDTHS)
    sdf = pt.rcfg.sdf
    C, E = sdf.n_comp, 3 + 6 * sdf.sdf_multires
    assert pst.head_route(torch.float32, 7, 1, C, E, sdf.sdf_dim,
                          1 + sdf.app_dim) == 'general'
    (j_terms, j_grads), = _jax_run(jt, 1)[0]
    p_terms, = pt.train(n_steps=1, log_every=1)
    for k, v in j_terms.items():
        np.testing.assert_allclose(p_terms[k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    p_grads = {path: t.grad.numpy() for path, t in named_leaves(pt.params)}
    assert sorted(j_grads) == sorted(p_grads)
    assert p_grads[('sdf', 'mlp', 1, 'w')].shape == (sdf.sdf_dim, 257)
    for path, jg in j_grads.items():
        scale = float(np.abs(jg).max()) + 1e-12
        np.testing.assert_allclose(p_grads[path] / scale, jg / scale,
                                   atol=1e-3, err_msg=f'grad {path}')
