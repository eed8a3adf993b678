"""Reference-format parameters in and out of the port
(``mfvae_tpu_torch/models/import_reference.py``) against the JAX package's
``mfvae_tpu/models/import_reference.py``.

The reference-structure tree is built here in numpy (per-agent
``encoders_<agent>`` with named ``fc{i}`` hiddens and an unnamed
``Dense_0`` output, ``action_encoders_<agent>``, joint decoders of unnamed
Denses, ``idx_emb``, ``reward_linear``: the structure of
tests/test_import_reference.py's ``RefMAVAE``), discrete and continuous.
Imports and exports must be bit-equal to JAX's through the bridge, the
imported model's posterior-mean forward within rtol 1e-6 of the JAX
model's; pickles load only numpy.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.models import import_reference as jref
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu_torch.config import ModelConfig
from mfvae_tpu_torch.models import import_reference as ref
from mfvae_tpu_torch.models.convert import params_from_jax, params_to_jax
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from tests.test_export_reference import AGENTS, OBS
from tests.test_export_reference import build as j_build
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
IDX_F, OBS_F, ACT_F, N_ACT = 4, 4, 3, 5
ENC_HIDDEN, ACT_HIDDEN, DEC_HIDDEN = (8, 8), (6,), (16, 12)
DISCRETE = pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])


def _dense(rng, n_in, n_out):
    return {"kernel": rng.normal(size=(n_in, n_out)).astype(np.float32) / np.sqrt(n_in),
            "bias": rng.normal(size=(n_out,)).astype(np.float32)}


def ref_tree(discrete=True, seed=0):
    """The reference's per-agent parameter tree, in numpy."""
    rng = np.random.default_rng(seed)
    n = len(AGENTS)
    tree = {"idx_emb": {"embedding": rng.normal(size=(n, IDX_F)).astype(np.float32)}}
    for a in AGENTS:
        widths = [IDX_F + OBS[a], *ENC_HIDDEN]
        enc = {f"fc{i}": _dense(rng, widths[i], widths[i + 1]) for i in range(len(ENC_HIDDEN))}
        enc["Dense_0"] = _dense(rng, widths[-1], 2 * OBS_F)
        tree[f"encoders_{a}"] = enc
        if discrete:
            tree[f"action_encoders_{a}"] = {"embedding": rng.normal(size=(N_ACT, ACT_F)).astype(np.float32)}
        else:
            widths = [N_ACT, *ACT_HIDDEN, ACT_F]
            tree[f"action_encoders_{a}"] = {f"Dense_{i}": _dense(rng, widths[i], widths[i + 1])
                                            for i in range(len(widths) - 1)}
    for dec, out in (("state_decoder", sum(OBS.values())), ("reward_decoder", n)):
        widths = [n * (OBS_F + ACT_F), *DEC_HIDDEN, out]
        tree[dec] = {f"Dense_{i}": _dense(rng, widths[i], widths[i + 1]) for i in range(len(widths) - 1)}
    tree["reward_linear"] = _dense(rng, n, n)
    return tree


def cfg_kw(discrete=True, fused=False, **kw):
    return dict(idx_features=IDX_F, obs_features=OBS_F, action_features=ACT_F, discrete_act=discrete,
                encoder_hidden=ENC_HIDDEN, action_encoder_hidden=ACT_HIDDEN, decoder_hidden=DEC_HIDDEN,
                compute_dtype="float32", fused_decoders=fused, **kw)


def port_model(discrete=True, fused=False, **kw):
    spec = AgentSpec.from_dicts(AGENTS, OBS, {a: N_ACT for a in AGENTS})
    return spec, MAVAE.from_config(ModelConfig(**cfg_kw(discrete, fused, **kw)), spec, device="cpu")


def assert_state_dicts_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def assert_trees_equal(a, b, path=""):
    assert isinstance(b, dict) and set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), f"{path}/{k}"


def inputs(spec, discrete, seed=1, b=4):
    rng = np.random.default_rng(seed)
    obs = [rng.normal(size=(b, len(i), od)).astype(np.float32) for (od, _), i in spec.groups]
    if discrete:
        act = [rng.integers(0, N_ACT, size=(b, len(i))).astype(np.int32) for _, i in spec.groups]
    else:
        act = [rng.normal(size=(b, len(i), N_ACT)).astype(np.float32) for _, i in spec.groups]
    return obs, act


# ------------------------------------------------------------------ import
@DISCRETE
def test_import_is_bit_equal_to_jax(discrete):
    tree = ref_tree(discrete)
    spec, model = port_model(discrete)
    got = ref.import_reference_params(tree, spec)
    want = params_from_jax(jax.device_get(jref.import_reference_params(tree, spec)))
    assert_state_dicts_equal(got, want)
    model.load_state_dict(got)  # strict: every leaf of the unfused layout
    assert_state_dicts_equal(ref.import_reference_params({"params": tree}, spec), got)


@DISCRETE
def test_imported_mean_call_matches_jax(discrete):
    from mfvae_tpu.config import ModelConfig as JModelConfig
    from mfvae_tpu.models.mavae import GroupedBatch as JBatch

    tree = ref_tree(discrete)
    spec, model = port_model(discrete)
    model.load_state_dict(ref.import_reference_params(tree, spec))
    jmodel = JMAVAE.from_config(JModelConfig(**cfg_kw(discrete)), spec)
    obs, act = inputs(spec, discrete)
    want = jmodel.apply(jref.import_reference_params(tree, spec),
                        JBatch(obs=tuple(map(jnp.asarray, obs)), actions=tuple(map(jnp.asarray, act))),
                        method="mean_call")
    got = model.mean_call(GroupedBatch(obs=tuple(map(torch.from_numpy, obs)),
                                       actions=tuple(map(torch.from_numpy, act))))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_fused_target_is_refused():
    spec, model = port_model(fused=True)
    with pytest.raises(RuntimeError, match="state_decoder"):
        model.load_state_dict(ref.import_reference_params(ref_tree(), spec))


# ------------------------------------------------------------------ export
@DISCRETE
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_export_is_bit_equal_to_jax(discrete, fused):
    spec, _, _, _, variables = j_build(discrete=discrete, fused=fused)
    want = jref.export_reference_params(variables, spec)
    _, model = port_model(discrete, fused)
    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    got = ref.export_reference_params(model, spec)
    assert_trees_equal(got, want)
    assert_trees_equal(ref.export_reference_params(model.state_dict(), spec), want)


@DISCRETE
def test_export_import_round_trip_is_bit_equal(discrete):
    spec, model = port_model(discrete)
    back = ref.import_reference_params(ref.export_reference_params(model, spec), spec)
    assert_state_dicts_equal(back, model.state_dict())


@pytest.mark.parametrize("kw", [{"det_features": 4}, {"latent_structure": "shared_private", "shared_latent": 4}],
                         ids=["det_features", "shared_private"])
def test_non_reference_architectures_are_refused(kw):
    spec, _, _, _, variables = j_build(**kw)
    with pytest.raises(ValueError, match="reference-representable"):
        jref.export_reference_params(variables, spec)
    _, model = port_model(**kw)
    with pytest.raises(ValueError, match="reference-representable"):
        ref.export_reference_params(model, spec)


# ----------------------------------------------------------------- pickles
def test_pickle_round_trip(tmp_path):
    spec, model = port_model()
    path = str(tmp_path / "model_state.pkl")
    ref.save_reference_pickle(model, spec, path)
    assert_state_dicts_equal(ref.load_reference_pickle(path, spec), model.state_dict())
    # a file the JAX package writes from the same parameters reads the same
    jax_path = str(tmp_path / "jax_state.pkl")
    jref.save_reference_pickle({"params": jax.tree.map(jnp.asarray, params_to_jax(model.state_dict()))},
                               spec, jax_path)
    assert_state_dicts_equal(ref.load_reference_pickle(jax_path, spec), model.state_dict())
    for protocol in (2, 5):  # numpy's classes differ by protocol
        with open(path, "wb") as f:
            pickle.dump(ref_tree(), f, protocol=protocol)
        assert_state_dicts_equal(ref.load_reference_pickle(path, spec), ref.import_reference_params(ref_tree(), spec))


class _Leaf:
    pass


class _Shell:
    def __reduce__(self):
        return (subprocess.call, (["true"],))


@pytest.mark.parametrize("leaf", [_Leaf(), _Shell(), __import__("collections").OrderedDict(a=1)],
                         ids=["custom class", "reduce to a call", "OrderedDict"])
def test_pickle_of_another_class_is_refused(tmp_path, leaf):
    path = tmp_path / "x.pkl"
    tree = ref_tree()
    tree["idx_emb"]["embedding"] = leaf
    path.write_bytes(pickle.dumps(tree))
    with pytest.raises(ValueError, match="convert its leaves to numpy first"):
        ref.load_reference_pickle(str(path), port_model()[0])


def test_pickle_of_jax_arrays_is_refused_without_importing_jax(tmp_path):
    path = tmp_path / "jax_arrays.pkl"
    path.write_bytes(pickle.dumps({"idx_emb": {"embedding": jnp.ones((5, IDX_F))}}))
    code = (
        "import sys\n"
        "from mfvae_tpu_torch.models.import_reference import load_numpy_pickle\n"
        "try:\n"
        f"    load_numpy_pickle({str(path)!r})\n"
        "except ValueError as e:\n"
        "    print('refused:', e)\n"
        "print('jax imported:', 'jax' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True).stdout
    assert "refused: this pickle needs jax" in out and "jax imported: False" in out, out


# -------------------------------------------------------------- torch side
def _torch_ver_state_dict(seed=0):
    """The torch reference's registered modules only (its per-agent
    encoders sit in plain dicts and never reach state_dict)."""
    torch.manual_seed(seed)

    def seq_mlp(in_dim, out_dim):
        layers, d = [], in_dim
        for h in DEC_HIDDEN:
            layers += [torch.nn.Linear(d, h), torch.nn.ReLU()]
            d = h
        return torch.nn.Sequential(*layers, torch.nn.Linear(d, out_dim))

    n = len(AGENTS)
    m = torch.nn.Module()
    m.idx_emb = torch.nn.Embedding(n, IDX_F)
    m.state_decoder, m.reward_decoder, m.decoder = torch.nn.Module(), torch.nn.Module(), torch.nn.Module()
    m.state_decoder.net = seq_mlp((OBS_F + ACT_F) * n, sum(OBS.values()))
    m.reward_decoder.net = seq_mlp((OBS_F + ACT_F) * n, n)
    m.decoder.net = seq_mlp((OBS_F + ACT_F) * n, 3)  # the unused legacy joint decoder
    m.reward_linear = torch.nn.Linear(n, n)
    return m.state_dict()


def test_torch_state_dict_transfers_as_in_jax(tmp_path):
    sd = _torch_ver_state_dict()
    spec, _, _, _, variables = j_build()
    jvars, jmissing = jref.import_torch_state_dict(sd, variables)
    _, model = port_model()
    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got, missing = ref.import_torch_state_dict(sd, model)
    assert missing == jmissing and "unmapped:decoder" in missing
    assert_state_dicts_equal(got, params_from_jax(jax.device_get(jvars)))
    assert_state_dicts_equal(model.state_dict(), before)  # the model itself is left as it was
    torch.save(sd, str(tmp_path / "test.pt"))
    got2, missing2 = ref.load_torch_checkpoint(str(tmp_path / "test.pt"), model)
    assert missing2 == missing
    assert_state_dicts_equal(got2, got)
