"""The port's reference-checkpoint loaders (``utils/torch_port.py``), its
golden harness (``golden.py``) and the ``golden`` / ``convert-checkpoint``
commands, against the JAX package on the CPU at tiny sizes.

* The loaders: a reference-layout state_dict is built from JAX-initialised
  parameters by the test-only inverses of ``torch_reference_layout.py``
  (``flax_tree`` must invert ``utils/convert.py`` exactly), which the JAX
  package's own
  ``utils/torch_port.py`` must map back to those parameters exactly; the
  port's loader of that state_dict then gives a model whose forward equals
  the JAX forward within DESIGN.md §6's tolerances (AE and UNet 1e-3,
  AToM 2e-4). Two heads of the UNet's qkv swapped, or the head-major →
  q|k|v-major permutation left out, fall outside them.
* LPIPS from fabricated ``vgg.pth`` and trunk files, both trunk formats;
  ``convert_all``'s dispatch and the missing-trunk skip; the registry's
  arity; ``convert-checkpoint``.
* The probes: the deterministic ones (``mtov_extract``, ``recon_coeff``)
  and, fed JAX's draws, the sampled ones equal the JAX package's
  ``run_probes`` on the same weights (1e-3; AToM 2e-4); record → check
  passes, a perturbed golden fails, ``golden --mode check`` exits 1.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu import config as jcfg
from moditalker_tpu import golden as jgolden
from moditalker_tpu.models.atom import MotionDecoder as JMotionDecoder
from moditalker_tpu.models.mtov import TriplaneUNet as JUNet
from moditalker_tpu.models.mtov import ViTAutoencoder as JAE
from moditalker_tpu.models.mtov.losses import LPIPS as JLPIPS
from moditalker_tpu.utils import torch_port as jtp
from moditalker_tpu_torch import cli, golden
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.core.checkpoint import load_single, save_single
from moditalker_tpu_torch.models.atom import MotionDecoder
from moditalker_tpu_torch.models.mtov import TriplaneUNet, ViTAutoencoder
from moditalker_tpu_torch.models.mtov.losses import LPIPS
from moditalker_tpu_torch.utils import convert
from moditalker_tpu_torch.utils import torch_port as ttp

from .test_torch_atom import TINY_MODEL
from .test_torch_atom import jax_params as atom_jax_params
from .test_torch_mtov_models import TINY_AE, TINY_UNET
from .test_torch_mtov_models import jax_params as mtov_jax_params
from .torch_reference_layout import (ae_reference_sd, atom_reference_sd,
                                     flax_tree, unet_kw, unet_reference_sd,
                                     write_vgg_files)
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

AE_TOL = dict(rtol=0, atol=1e-3)
ATOM_TOL = dict(rtol=0, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


# ------------------------------------------------------------ the loaders
def test_atom_loader_matches_jax_forward():
    params = atom_jax_params()
    n = TINY_MODEL["num_layers"]
    d = TINY_MODEL["latent_dim"]
    _assert_trees_equal(flax_tree(convert.convert_atom_params(params)), params)
    sd = atom_reference_sd(params, n)
    _assert_trees_equal(jtp.convert_atom_decoder(sd, n, d), params)
    _assert_trees_equal(ttp.atom_decoder_tree(sd, n, d), params)
    model = MotionDecoder(tcfg.AtomModelConfig(**TINY_MODEL))
    model.load_state_dict(ttp.convert_atom_decoder(
        {k: torch.tensor(v) for k, v in sd.items()}, n, d))
    rng = np.random.default_rng(1)
    h = TINY_MODEL["horizon"]
    x, face = (rng.normal(size=(2, h, 204)).astype(np.float32)
               for _ in range(2))
    cond = rng.normal(size=(2, 2 * h, 1024)).astype(np.float32)
    times = np.array([1, 13], np.int32)
    want = JMotionDecoder(jcfg.AtomModelConfig(**TINY_MODEL)).apply(
        params, x, face, cond, times)
    with torch.no_grad():
        got = model.eval()(_t(x), _t(face), _t(cond),
                           torch.from_numpy(times).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOM_TOL)


def test_vit_autoencoder_loader_matches_jax_forward():
    rgb, _, _ = mtov_jax_params()
    cfg = tcfg.MtovAEConfig(**TINY_AE)
    _assert_trees_equal(flax_tree(convert.convert_ae_params(rgb)), rgb)
    sd = ae_reference_sd(rgb, cfg.depth, cfg.quant_depth)
    _assert_trees_equal(jtp.convert_vit_autoencoder(sd, cfg.depth,
                                                    cfg.quant_depth), rgb)
    ae = ViTAutoencoder(cfg)
    ae.load_state_dict(ttp.convert_vit_autoencoder(sd, cfg.depth,
                                                   cfg.quant_depth))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 4, 32, 32, 3)).astype(
        np.float32)
    jae = JAE(jcfg.MtovAEConfig(**TINY_AE))
    want = jax.jit(lambda p, v: jae.apply(p, v, method=jae.extract))(rgb, x)
    with torch.no_grad():
        got = ae.eval().extract(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **AE_TOL)


def _unet_case(sd):
    """The port's UNet from a reference-layout sd vs the JAX UNet's forward:
    max abs error."""
    _, _, up = mtov_jax_params()
    cfg = tcfg.MtovUNetConfig(**TINY_UNET)
    unet = TriplaneUNet(cfg)
    unet.load_state_dict(ttp.convert_triplane_unet(sd, **unet_kw(cfg)))
    rng = np.random.default_rng(1)
    x, cond, ic = (rng.normal(size=(2, c, 48)).astype(np.float32)
                   for c in (4, 8, 4))
    t = np.array([3, 17], np.int32)
    want = jax.jit(JUNet(jcfg.MtovUNetConfig(**TINY_UNET)).apply)(
        up, x, cond, ic, t)
    with torch.no_grad():
        got = unet.eval()(_t(x), _t(cond), _t(ic), torch.from_numpy(t).long())
    return float(np.abs(got.numpy() - np.asarray(want)).max())


def test_triplane_unet_loader_matches_jax_forward():
    _, _, up = mtov_jax_params()
    cfg = tcfg.MtovUNetConfig(**TINY_UNET)
    _assert_trees_equal(flax_tree(convert.convert_unet_params(up)), up)
    sd = unet_reference_sd(up, cfg)
    _assert_trees_equal(jtp.convert_triplane_unet(
        sd, cfg.model_channels, **unet_kw(cfg)), up)
    _assert_trees_equal(ttp.triplane_unet_tree(sd, **unet_kw(cfg)), up)
    assert _unet_case(sd) <= AE_TOL["atol"]


@pytest.mark.parametrize("fault", ["swapped_heads", "no_permutation"])
def test_a_wrong_qkv_layout_fails_the_unet_check(fault, monkeypatch):
    """Two heads of one attention's qkv swapped in the reference file, or
    the head-major → q|k|v-major permutation left out: the forward falls
    outside the tolerance (reads 1e-1 and above)."""
    _, _, up = mtov_jax_params()
    cfg = tcfg.MtovUNetConfig(**TINY_UNET)
    sd = unet_reference_sd(up, cfg)
    if fault == "swapped_heads":
        name = "mid_attn.qkv"
        for key in (f"{name}.weight", f"{name}.bias"):
            rows = sd[key].shape[0] // cfg.num_heads
            w = sd[key].copy()
            w[:rows], w[rows:2 * rows] = sd[key][rows:2 * rows], sd[key][:rows]
            sd[key] = w
    else:
        monkeypatch.setattr(ttp, "qkv_headmajor_to_qkvmajor",
                            lambda w, b, heads: (w, b))
    assert _unet_case(sd) > 10 * AE_TOL["atol"]


# ------------------------------------------------------------------ LPIPS
def _lpips_matches_jax(d, state):
    trunk = golden.load_vgg16_features_sd(str(d))
    heads = golden.load_torch_state_dict(str(d / "vgg.pth"))
    jparams = jtp.convert_lpips({k: v.numpy() for k, v in trunk.items()},
                                {k: v.numpy() for k, v in heads.items()})
    rng = np.random.default_rng(1)
    x, y = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(JLPIPS().apply(jparams, x, y))
    model = LPIPS()
    model.load_state_dict(state)
    with torch.no_grad():
        got = model.eval()(_t(x), _t(y)).numpy()
    assert want.min() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_convert_all_lpips_round_trip(tmp_path):
    """vgg.pth beside the full-model trunk file → ``convert_all`` writes the
    port's LPIPS state_dict, whose distance equals the JAX LPIPS's from the
    JAX converter on the same files."""
    write_vgg_files(tmp_path)
    done = golden.convert_all(str(tmp_path), str(tmp_path / "out"))
    assert set(done) == {"vgg.pth"}
    assert done["vgg.pth"] == str(tmp_path / "out" / "vgg.pt")
    state = load_single(done["vgg.pth"])
    assert state["lin_0"].shape == (64, 1)
    _lpips_matches_jax(tmp_path, state)


def test_convert_all_missing_trunk_skips_cleanly(tmp_path, capsys):
    write_vgg_files(tmp_path, trunk=False)
    done = golden.convert_all(str(tmp_path), str(tmp_path / "out"))
    assert done == {}
    err = capsys.readouterr().err
    assert "skipped vgg.pth [lpips]" in err and "missing: atom.pt" in err


def test_convert_checkpoint_command_lpips(tmp_path):
    """``convert-checkpoint --kind lpips`` with the bare-features trunk."""
    write_vgg_files(tmp_path, full_model_prefix=False)
    out = tmp_path / "lpips.pt"
    cli.main(["convert-checkpoint", "--torch-ckpt", str(tmp_path / "vgg.pth"),
              "--kind", "lpips", "--vgg16",
              str(tmp_path / golden.VGG16_TRUNK_FILE), "--out", str(out)])
    _lpips_matches_jax(tmp_path, torch.load(str(out), weights_only=True))


def test_every_kind_has_a_uniform_arity_converter():
    kinds = set(golden.CKPT_KINDS.values()) | {"hubert"}
    assert kinds == set(jgolden.CKPT_KINDS.values()) | {"hubert"}
    assert golden.CKPT_KINDS == jgolden.CKPT_KINDS
    for kind in kinds:
        sig = inspect.signature(golden._converter(kind))
        assert len(sig.parameters) == 2, (kind, sig)
    with pytest.raises(KeyError):
        golden._converter("nope")


def test_load_torch_state_dict_unwraps_atom_containers(tmp_path):
    w = torch.arange(6.0).reshape(2, 3)
    torch.save({"ema_state_dict": {"module.a.weight": w},
                "model_state_dict": {"module.a.weight": -w},
                "optimizer": {}}, str(tmp_path / "atom.pt"))
    ema = golden.load_torch_state_dict(str(tmp_path / "atom.pt"))
    raw = golden.load_torch_state_dict(str(tmp_path / "atom.pt"), ema=False)
    assert torch.equal(ema["a.weight"], w) and torch.equal(raw["a.weight"], -w)


# ------------------------------------------------------------------ probes
@pytest.fixture(scope="module")
def jax_probe_run(tmp_path_factory):
    """The JAX harness's tiny probes (its own init from PRNGKey(1234)); the
    same weights converted into a port params dir; JAX's draws for the two
    samplers."""
    d = tmp_path_factory.mktemp("params")
    key = jax.random.PRNGKey(golden.SEED)
    mc, ae_cfg, unet_cfg = (jcfg.AtomModelConfig(horizon=16),
                            *[getattr(jcfg, type(c).__name__)(**vars(c))
                              for c in golden.probe_configs("tiny")[1:]])
    h, L = mc.horizon, ae_cfg.latent_len
    atom = jax.jit(JMotionDecoder(mc).init)(
        key, jnp.zeros((1, h, 204)), jnp.zeros((1, h, 204)),
        jnp.zeros((1, 2 * h, 1024)), jnp.zeros((1,), "int32"))
    ae = jax.jit(JAE(ae_cfg).init)(key, jnp.zeros((1, ae_cfg.timesteps,
                                          ae_cfg.resolution,
                                          ae_cfg.resolution, 3)))
    unet = jax.jit(JUNet(unet_cfg).init)(key, jnp.zeros((1, 4, L)),
                                jnp.zeros((1, 8, L)), jnp.zeros((1, 4, L)),
                                jnp.zeros((1,), "int32"))
    from moditalker_tpu.preprocess.recon_net import ReconNet as JRecon

    recon = _np_tree(jax.jit(JRecon().init)(key, jnp.zeros((1, 224, 224,
                                                            3))))
    # the heads start at zero: random heads, so that the probe reads the
    # trunk; the JAX harness reads them from its own params dir
    rng = np.random.default_rng(0)
    for name, head in recon["params"].items():
        if name.startswith("head_"):
            head["kernel"] = rng.normal(scale=0.02, size=head["kernel"].shape
                                        ).astype(np.float32)
    from moditalker_tpu.core.checkpoint import save_single as jsave

    jdir = tmp_path_factory.mktemp("jax_params")
    jsave(os.path.join(jdir, "epoch_20"), recon)
    for stem, state in (
            ("atom", convert.convert_atom_params(_np_tree(atom))),
            ("autoencoder_rgb", convert.convert_ae_params(_np_tree(ae))),
            ("autoencoder_motion", convert.convert_ae_params(_np_tree(ae))),
            ("diffusion_model", convert.convert_unet_params(_np_tree(unet))),
            ("epoch_20", convert.convert_recon_params(recon))):
        save_single(os.path.join(d, stem + ".pt"), state)

    def draws(shape, steps):
        k, sub = jax.random.split(key)
        return [np.asarray(jax.random.normal(sub, shape))] + [
            np.asarray(jax.random.normal(s, shape))
            for s in jax.random.split(k, steps)]

    noise = {"atom_sequence": draws((1, h, 204), 4),
             "mtov_window": draws((1, 4, L), 4)}
    return {"dir": str(d), "noise": noise,
            "want": jgolden.run_probes(str(jdir), tiny=True)}


def test_probes_match_jax_run_probes(jax_probe_run):
    got = golden.run_probes(jax_probe_run["dir"], tiny=True, device="cpu",
                            noise=jax_probe_run["noise"])
    want = jax_probe_run["want"]
    assert set(got) == set(want) == {"atom_sequence", "mtov_window",
                                     "mtov_extract", "recon_coeff"}
    assert np.abs(want["recon_coeff"]).max() > 0.1
    for name in want:
        assert got[name].shape == want[name].shape, name
        tol = ATOM_TOL if name == "atom_sequence" else AE_TOL
        scale = max(1.0, float(np.abs(want[name]).max()))
        np.testing.assert_allclose(got[name] / scale, want[name] / scale,
                                   **tol, err_msg=name)


def test_record_check_and_a_perturbed_golden(tmp_path, capsys):
    """``golden --mode record`` then ``--mode check`` on the port's own
    tiny probes passes (the probes are deterministic); a golden with one
    probe perturbed fails ``compare_probes`` and makes ``check`` exit 1."""
    g = tmp_path / "goldens.npz"
    cli.main(["golden", "--mode", "record", "--golden", str(g), "--tiny",
              "--device", "cpu"])
    assert cli.main(["golden", "--mode", "check", "--golden", str(g),
                     "--tiny", "--device", "cpu"]) is True
    assert '"ok": true' in capsys.readouterr().out
    data = dict(np.load(g))
    data["mtov_window"] = data["mtov_window"] + 1e-2
    ok, report = golden.compare_probes(golden.run_probes(
        None, tiny=True, device="cpu"), data)
    assert not ok and "mtov_window" in report
    bad = tmp_path / "bad.npz"
    np.savez_compressed(bad, **data)
    with pytest.raises(SystemExit) as e:
        cli.main(["golden", "--mode", "check", "--golden", str(bad),
                  "--tiny", "--device", "cpu"])
    assert e.value.code == 1
    assert '"ok": false' in capsys.readouterr().out


def test_record_from_converted_weights_reads_them(jax_probe_run, tmp_path):
    """A params dir changes the probes (its files are read), and the golden
    ``convert`` mode with no ckpt dir exits."""
    a = golden.run_probes(jax_probe_run["dir"], tiny=True, device="cpu")
    b = golden.run_probes(None, tiny=True, device="cpu")
    assert not np.allclose(a["recon_coeff"], b["recon_coeff"])
    with pytest.raises(SystemExit):
        cli.main(["golden", "--mode", "convert"])
