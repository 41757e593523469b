"""The port's LM families on a device mesh, second part: qwen2-moe-a2.7b
(its shared experts' partial sums go with the routed experts'),
paligemma-3b (vlm: the patch prefix before the residual is split on the
sequence, the prefix-LM mask, the loss under the batch's mask; its smoke
variant's 4 heads over 1 KV head run every head on every coordinate) and
seamless-m4t-medium (encdec: the encoder's frames split on the sequence,
the cross-attention's K/V cache on the batch and KV heads) against the
JAX package's own (data 2, model 2) mesh run and the port's one-device
run, as ``tests/test_torch_lm_mesh_families.py`` holds the first part
(``tests/lm_mesh_parity.py``; the reference subprocess starts with this
module's first test)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding as shd  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import ShardCtx  # noqa: E402
import lm_mesh_parity as P  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "paligemma-3b", "seamless-m4t-medium"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Started with the module's first test; ``reference()`` waits for the
    subprocess and returns its arrays."""
    wait, stop = P.start_reference(tmp_path_factory.mktemp("reference"),
                                   ARCHS)
    yield wait
    stop()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference):
    yield


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_mesh(arch, reference):
    P.check_train_vs_reference(arch, reference())


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_one_device(arch, mesh_shape, reference):
    P.check_train_vs_one_device(arch, mesh_shape, reference())


@pytest.mark.parametrize("b", [P.B, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference_mesh(arch, b, reference):
    P.check_serving_vs_reference(arch, b, reference())


def test_vlm_heads_replicated_when_kv_heads_do_not_divide(monkeypatch):
    """paligemma's smoke variant has 4 query heads over 1 KV head: the KV
    heads do not divide the model axis, so ``wk`` stays whole and every
    coordinate computes all 4 heads (``_heads_axes`` is empty) on its
    rows of the patches + tokens; the MLP and the vocab still split."""
    cfg = smoke_variant(get_config("paligemma-3b"))
    mesh = P.mesh22()
    ctx = ShardCtx(mesh, shd.make_rules(mesh, cfg))
    params = api.shard_params(api.init_params(cfg, 0, "cpu"), cfg, ctx)
    assert params["layers.0.attn.wk"].spec[1] is None
    assert params["layers.0.attn.wq"].spec[1] == "model"
    seen = {"wq": set(), "x": set()}
    attn = tf.attention_block

    def rec(p, x, *a, **k):
        seen["wq"].add(tuple(p["wq"].shape))
        seen["x"].add(tuple(x.shape))
        assert k["prefix_len"] == cfg.num_prefix_embeds
        return attn(p, x, *a, **k)

    monkeypatch.setattr(tf, "attention_block", rec)
    batch = {k: v for k, v in P.to_torch(P.batch_np(cfg)).items()}
    with torch.no_grad():
        loss, m = api.loss_fn(params, batch, cfg, ctx)
    assert torch.isfinite(loss)
    assert float(m["tokens"]) == float(batch["mask"].sum())
    assert seen["wq"] == {(cfg.d_model, cfg.eff_num_heads, cfg.head_dim)}
    assert seen["x"] == {(P.B // 2, P.T, cfg.d_model)}
