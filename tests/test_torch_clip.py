"""PyTorch port, CLIP (``models/clip.py``, ``models/clip_ensemble.py``,
``data/clip_{preprocess,tokenizer}.py``, the CLIP loaders of
``interop/torch_bridge.py`` and ``cli/precompute_clip.py``) held against the
JAX package at ``CLIPConfig.tiny()``: the towers and the logit pair against
JAX ``models/clip.py`` on weights in OpenAI's layout, the HF-layout bridge
through a random ``transformers.CLIPModel`` built offline, the tokenizer and
the preprocessing against their JAX copies, the four CLIP ensembles (from
embeddings and from pixels) with a tie case for the top-2 gate, and the
command's packs against the JAX command's on the same inputs.  fp32, atol =
rtol = 2e-4 (the bound of the other port tests), exact where both sides run
the same numpy."""

import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_context_reasoning_tpu.cli import precompute_clip as jcli
from multimodal_context_reasoning_tpu.core.config import CLIPConfig as JCLIPConfig
from multimodal_context_reasoning_tpu.data import clip_preprocess as jpre
from multimodal_context_reasoning_tpu.data import clip_tokenizer as jtok
from multimodal_context_reasoning_tpu.interop.clip_torch import CLIPTorch
from multimodal_context_reasoning_tpu.interop.torch_bridge import convert_clip as jconvert
from multimodal_context_reasoning_tpu.models import clip_ensemble as jce
from multimodal_context_reasoning_tpu.models.clip import CLIP as JCLIP
from multimodal_context_reasoning_torch.cli import precompute_clip as tcli
from multimodal_context_reasoning_torch.core.config import CLIPConfig
from multimodal_context_reasoning_torch.data import clip_preprocess as tpre
from multimodal_context_reasoning_torch.data import clip_tokenizer as ttok
from multimodal_context_reasoning_torch.data.feature_store import FeatureStore
from multimodal_context_reasoning_torch.interop.from_jax import (
    clip_params_from_jax,
    ensemble_params_from_jax,
)
from multimodal_context_reasoning_torch.interop.torch_bridge import (
    convert_clip,
    load_clip_checkpoint,
)
from multimodal_context_reasoning_torch.models import clip_ensemble as tce
from multimodal_context_reasoning_torch.models.clip import CLIP

TOL = dict(rtol=2e-4, atol=2e-4)
CFG = CLIPConfig.tiny()
JCFG = JCLIPConfig.tiny()
KEY = jax.random.PRNGKey(0)
WORDS = ["a", "photo", "of", "the", "cat", "dog", "sitting", "on", "mat", "person", "hat",
         "red"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side is tiny: one intra-op thread keeps it off the cores
    the other test workers use (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), np.asarray(want),
                               **TOL, err_msg=what)


def _port(sd, cfg=CFG):
    """The port's CLIP on the CPU, carrying an OpenAI-layout numpy dict."""
    model = CLIP(cfg, device="cpu").eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


@pytest.fixture(scope="module")
def towers():
    """A seeded OpenAI-layout transcription's weights on both sides."""
    torch.manual_seed(0)
    sd = {k: v.detach().numpy() for k, v in CLIPTorch(JCFG).state_dict().items()}
    params = {"params": jconvert(sd)}
    return dict(sd=sd, params=params, port=_port(convert_clip(sd)), j=JCLIP(JCFG))


@jax.jit
def _jax_towers(params, px, ids):
    """JAX ``encode_image``, ``encode_text`` and the logit pair, one program."""
    j = JCLIP(JCFG)
    return (j.apply(params, px, method=j.encode_image),
            j.apply(params, ids, method=j.encode_text), *j.apply(params, px, ids))


def _inputs(seed=0, q=4, rows=4, cfg=CFG):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(q, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size - 1, size=(rows, cfg.context_length)).astype(np.int64)
    ids[:, -1] = cfg.vocab_size - 1   # EOT: the max id, once per row
    ids[1, 5:] = 0                    # a padded row: EOT earlier
    ids[1, 4] = cfg.vocab_size - 1
    return px, ids


# ------------------------------------------------------------ the towers

def test_towers_and_logits_match_jax(towers):
    px, ids = _inputs()
    port = towers["port"]
    with torch.no_grad():
        img = port.encode_image(torch.from_numpy(px))
        txt = port.encode_text(torch.from_numpy(ids))
        li, lt = port(torch.from_numpy(px), torch.from_numpy(ids))
    want = _jax_towers(towers["params"], px, ids.astype(np.int32))
    for name, got, w in zip(("image", "text", "logits_per_image", "logits_per_text"),
                            (img, txt, li, lt), want):
        _close(got, w, name)
    assert img.shape == (4, CFG.embed_dim) and txt.shape == (4, CFG.embed_dim)


def test_openai_layout_and_from_jax(towers):
    """The port's state dict has exactly OpenAI's keys and shapes (the
    transcription's), and ``clip_params_from_jax`` of the JAX tree gives
    back the same values."""
    sd = towers["sd"]
    port_sd = towers["port"].state_dict()
    assert set(port_sd) == set(sd)
    assert all(tuple(port_sd[k].shape) == sd[k].shape for k in sd)
    from_jax = clip_params_from_jax(jax.tree.map(np.asarray, towers["params"]))
    assert set(from_jax) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(from_jax[k].numpy(), v, err_msg=k)


def test_init_is_finite_on_every_parameter():
    model = CLIP(CFG, device="cpu", generator=torch.Generator().manual_seed(1))
    px, ids = _inputs(seed=1)
    with torch.no_grad():
        li, _ = model(torch.from_numpy(px), torch.from_numpy(ids))
    assert torch.isfinite(li).all()
    np.testing.assert_allclose(model.logit_scale.item(), np.log(1 / 0.07), rtol=1e-6)


def test_bf16_towers_are_finite_and_close():
    """bf16 compute over fp32 parameters, against the JAX towers in bf16 on
    the same weights (the two round at the same points but sum in their own
    orders: 2e-2 of max |JAX|, the port's bf16 kernel tolerance) and against
    the fp32 towers (bf16 rounds every product: 5e-2 of max |fp32|)."""
    torch.manual_seed(3)
    sd = {k: v.detach().numpy() for k, v in CLIPTorch(JCFG).state_dict().items()}
    params = {"params": jconvert(sd)}
    j16 = JCLIP(dataclasses.replace(JCFG, dtype="bfloat16"))
    f32, b16 = _port(convert_clip(sd)), _port(convert_clip(sd),
                                              dataclasses.replace(CFG, dtype="bfloat16"))
    px, ids = _inputs(seed=3)
    with torch.no_grad():
        for enc, x in (("encode_image", px), ("encode_text", ids)):
            want = getattr(f32, enc)(torch.from_numpy(x))
            got = getattr(b16, enc)(torch.from_numpy(x))
            jx = x.astype(np.int32) if x.dtype == np.int64 else x
            jax16 = np.asarray(j16.apply(params, jx, method=getattr(j16, enc)), np.float32)
            assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
            assert np.abs(got.float().numpy() - jax16).max() <= 2e-2 * np.abs(jax16).max(), enc
            assert (got.float() - want).abs().max() <= 5e-2 * want.abs().max()


# ------------------------------------------------------------ the bridge

def test_hf_clipmodel_bridge_matches_hf_and_jax():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPConfig(
        projection_dim=CFG.embed_dim,
        text_config=dict(
            vocab_size=CFG.vocab_size, hidden_size=CFG.text_width,
            num_hidden_layers=CFG.text_layers, num_attention_heads=CFG.text_heads,
            intermediate_size=4 * CFG.text_width, max_position_embeddings=CFG.context_length,
            hidden_act="quick_gelu", layer_norm_eps=1e-5, eos_token_id=CFG.vocab_size - 1),
        vision_config=dict(
            image_size=CFG.image_size, patch_size=CFG.patch_size,
            hidden_size=CFG.vision_width, num_hidden_layers=CFG.vision_layers,
            num_attention_heads=CFG.vision_heads, intermediate_size=4 * CFG.vision_width,
            hidden_act="quick_gelu", layer_norm_eps=1e-5),
    )
    torch.manual_seed(1)
    hf = transformers.CLIPModel(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    port = _port(convert_clip(sd))
    px, ids = _inputs(seed=1)
    want = _jax_towers({"params": jconvert(sd)}, px, ids.astype(np.int32))
    with torch.no_grad():
        img = port.encode_image(torch.from_numpy(px))
        txt = port.encode_text(torch.from_numpy(ids))
        ref_img = hf.get_image_features(pixel_values=torch.from_numpy(px).permute(0, 3, 1, 2))
        ref_txt = hf.get_text_features(input_ids=torch.from_numpy(ids))
    _close(img, ref_img, "hf image")
    _close(txt, ref_txt, "hf text")
    _close(img, want[0], "jax image")
    _close(txt, want[1], "jax text")


def test_load_clip_checkpoint_reads_both_archive_kinds(towers, tmp_path):
    """A plain ``torch.save`` dict and a TorchScript archive (OpenAI ships
    one) with the archive's extra integer entries, which convert_clip
    drops."""
    model = CLIPTorch(JCFG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in towers["sd"].items()})
    plain = tmp_path / "plain.pt"
    torch.save(model.state_dict(), str(plain))
    traced = tmp_path / "traced.pt"
    model.register_buffer("input_resolution", torch.tensor(CFG.image_size))
    torch.jit.save(torch.jit.trace_module(
        model.eval(), {"encode_image": torch.zeros(1, 3, CFG.image_size, CFG.image_size)}),
        str(traced))
    for path in (plain, traced):
        got = convert_clip(load_clip_checkpoint(str(path)))
        assert set(got) == set(towers["sd"])
        for k, v in towers["sd"].items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{path.name} {k}")


# ------------------------------------------------------------ tokenizer and preprocessing

@pytest.fixture(scope="module")
def merges():
    want = jtok.build_test_merges(WORDS * 3)
    assert ttok.build_test_merges(WORDS * 3) == want
    return want


def test_tokenizer_matches_jax(merges, tmp_path):
    """The same ids, rows and vocab as the JAX copy, from a merge list, a
    plain merges file and a gzipped one."""
    texts = ["a photo of the cat", "The   DOG, sitting on a red mat!", "person's hat 42",
             "naïve café"]
    lines = "#version: test\n" + "\n".join(" ".join(m) for m in merges) + "\n"
    (tmp_path / "m.txt").write_text(lines)
    with gzip.open(tmp_path / "m.txt.gz", "wt", encoding="utf-8") as f:
        f.write(lines)
    j = jtok.ClipTokenizer(merges)
    want = j.tokenize(texts, 16, truncate=True)
    for src in (merges, str(tmp_path / "m.txt"), str(tmp_path / "m.txt.gz")):
        t = ttok.ClipTokenizer(src)
        assert t.encoder == j.encoder and t.vocab_size == j.vocab_size
        np.testing.assert_array_equal(t.tokenize(texts, 16, truncate=True), want)
        assert [t.encode(x) for x in texts] == [j.encode(x) for x in texts]
        assert t.decode(t.encode(texts[0])) == j.decode(j.encode(texts[0])) == texts[0]
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()


def test_tokenizer_layout(merges):
    """The JAX tests' layout: 256 bytes + 256 </w> variants + merges + 2
    specials; SOT first, EOT last and the max id; overflow raises or cuts."""
    tok = ttok.ClipTokenizer(merges)
    assert tok.vocab_size == 512 + len(merges) + 2
    assert (tok.sot_id, tok.eot_id) == (tok.vocab_size - 2, tok.vocab_size - 1)
    ids = tok.tokenize(["a photo of the cat", "the dog"], context_length=16)
    assert ids.shape == (2, 16) and ids.dtype == np.int32 and ids[0, 0] == tok.sot_id
    assert ids[1][ids[1] != 0][-1] == tok.eot_id
    assert int(ids[0].argmax()) == int(np.where(ids[0] == tok.eot_id)[0][0])
    with pytest.raises(ValueError):
        tok.tokenize(["the cat " * 40], context_length=8)
    cut = tok.tokenize(["the cat " * 40], context_length=8, truncate=True)
    assert cut.shape == (1, 8) and cut[0, -1] == tok.eot_id
    assert tok.encode("The   CAT") == tok.encode("the cat")


@pytest.mark.parametrize("hw", [(64, 48), (100, 37), (37, 100), (50, 70), (480, 640)])
def test_preprocess_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    arr = rng.integers(0, 255, size=(*hw, 3)).astype(np.uint8)
    size = 224 if hw == (480, 640) else 32
    got = tpre.preprocess_image(arr, size)
    np.testing.assert_array_equal(got, jpre.preprocess_image(arr, size))
    np.testing.assert_array_equal(tpre.preprocess_image(Image.fromarray(arr), size), got)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(tpre.CLIP_MEAN, jpre.CLIP_MEAN)
    np.testing.assert_array_equal(tpre.CLIP_STD, jpre.CLIP_STD)


def test_preprocess_constant_and_torchvision_geometry():
    """A constant image normalizes exactly; 640x480 at 224 resizes to
    (298, 224) (the long side truncated) and crops at int(round(74 / 2))."""
    out = tpre.preprocess_images([np.full((64, 48, 3), 128, np.uint8)] * 2, image_size=32)
    assert out.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out, np.broadcast_to((128 / 255.0 - tpre.CLIP_MEAN)
                                                    / tpre.CLIP_STD, out.shape), atol=1e-6)
    arr = np.random.default_rng(2).integers(0, 255, size=(480, 640, 3)).astype(np.uint8)
    ref = Image.fromarray(arr).resize((298, 224), Image.BICUBIC).crop((37, 0, 261, 224))
    want = (np.asarray(ref, np.float32) / 255.0 - tpre.CLIP_MEAN) / tpre.CLIP_STD
    np.testing.assert_array_equal(tpre.preprocess_image(arr, 224), want)


# ------------------------------------------------------------ the ensembles

def _embs(Q=3, K=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Q, D)).astype(np.float32),
            rng.normal(size=(Q, K, D)).astype(np.float32))


def test_similarity_and_top2_gate_match_jax():
    img, txt = _embs()
    sim = tce.clip_similarity(torch.from_numpy(img), torch.from_numpy(txt))
    _close(sim, jce.clip_similarity(jnp.asarray(img), jnp.asarray(txt)), "similarity")
    gate = tce.clip_top2_gate(sim)
    _close(gate, jce.clip_top2_gate(jnp.asarray(sim.numpy())), "gate")
    s = sim.numpy()
    for q in range(3):
        top2 = np.argsort(-s[q], kind="stable")[:2]
        for k in range(4):
            want = np.mean(s[q][top2]) if k in top2 else 1.0
            np.testing.assert_allclose(gate[q, k].item(), want, rtol=1e-5)


def test_top2_gate_ties_go_to_the_lower_index():
    """lax.top_k's order: of tied scores the lower positions win."""
    sim = np.array([[0.5, 0.5, 0.5, 0.1],
                    [0.2, 0.9, 0.9, 0.9],
                    [0.3, 0.3, 0.3, 0.3],
                    [-0.4, 0.7, -0.4, -0.4]], np.float32)
    got = tce.clip_top2_gate(torch.from_numpy(sim)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jce.clip_top2_gate(jnp.asarray(sim))))
    want = np.array([[0.5, 0.5, 1, 1], [1, 0.9, 0.9, 1], [0.3, 0.3, 1, 1],
                     [0.15, 0.15, 1, 1]], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_gated_ensemble_and_similarity_fusion_match_jax():
    rng = np.random.default_rng(1)
    Q, K = 3, 4
    img, txt = _embs(Q, K)
    calec = rng.normal(size=(Q * K, 6)).astype(np.float32)
    rob = rng.normal(size=(Q * K, 10)).astype(np.float32)
    label = np.zeros((Q * K,), np.float32)
    label[::K] = 1.0
    jargs = [jnp.asarray(x) for x in (calec, rob, img, txt)]
    targs = [torch.from_numpy(x) for x in (calec, rob, img, txt)]
    jm = jce.ClipGatedEnsemble(num_labels=K)
    params = jax.tree.map(np.asarray, jm.init(KEY, *jargs))
    tm = tce.ClipGatedEnsemble(feature_dim=16, num_labels=K)
    tm.load_state_dict(ensemble_params_from_jax(params), strict=True)
    want = jm.apply(params, *jargs, label=jnp.asarray(label))
    got = tm(*targs, label=torch.from_numpy(label))
    _close(got.logits, want.logits, "gated logits")
    _close(got.loss, want.loss, "gated loss")
    # the gate changes the logits (ensemble_model_t1 semantics)
    flat = tm(*targs[:3], torch.zeros_like(targs[3]) + targs[3].mean()).logits
    assert not torch.allclose(got.logits, flat)

    base = rng.normal(size=(Q, K)).astype(np.float32)
    jf = jce.ClipSimilarityFusion(num_labels=K)
    fp = jf.init(KEY, jnp.asarray(base), *jargs[2:])
    want = jf.apply(fp, jnp.asarray(base), *jargs[2:], label=jnp.asarray(label))
    got = tce.ClipSimilarityFusion()(torch.from_numpy(base), *targs[2:],
                                     label=torch.from_numpy(label))
    _close(got.logits, want.logits, "fusion logits")
    _close(got.loss, want.loss, "fusion loss")


@pytest.mark.parametrize("variant", ["fusion", "product"])
def test_clip_only_model_matches_jax(variant):
    img, txt = _embs()
    label = np.eye(4, dtype=np.float32)[[0, 1, 2]]
    jm = jce.ClipOnlyModel(num_labels=4, variant=variant, clip_dim=8)
    params = jax.tree.map(np.asarray, jm.init(KEY, jnp.asarray(img), jnp.asarray(txt)))
    tm = tce.ClipOnlyModel(4, variant, clip_dim=8)
    tm.load_state_dict(ensemble_params_from_jax(params), strict=True)
    want = jm.apply(params, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(label))
    got = tm(torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(label))
    _close(got.logits, want.logits, "logits")
    _close(got.loss, want.loss, "loss")
    with pytest.raises(ValueError, match="unknown variant"):
        tce.ClipOnlyModel(variant="sum")


@pytest.mark.parametrize("variant", ["fusion", "product"])
def test_end_to_end_from_pixels_matches_jax(towers, variant):
    q, k = 2, 4
    px, _ = _inputs(seed=2, q=q)
    _, ids = _inputs(seed=2, rows=q * k)
    jm = jce.ClipEndToEnd(JCFG, num_labels=k, variant=variant)
    head = jce.ClipOnlyModel(num_labels=k, variant=variant, clip_dim=CFG.embed_dim)
    img, txt = _embs(q, k, CFG.embed_dim, seed=2)
    params = {"params": {"clip": towers["params"]["params"], "head": jax.tree.map(
        np.asarray, head.init(KEY, jnp.asarray(img), jnp.asarray(txt)))["params"]}}
    tm = tce.ClipEndToEnd(CFG, num_labels=k, variant=variant, device="cpu").eval()
    sd = {"clip." + n: v for n, v in clip_params_from_jax(params["params"]["clip"]).items()}
    sd.update({"head." + n: v for n, v in
               ensemble_params_from_jax(params["params"]["head"]).items()})
    tm.load_state_dict(sd, strict=True)
    label = np.zeros((q, k), np.float32)
    label[:, 0] = 1.0
    want = jax.jit(jm.apply)(params, jnp.asarray(px), jnp.asarray(ids, jnp.int32),
                             jnp.asarray(label))
    with torch.no_grad():
        got = tm(torch.from_numpy(px), torch.from_numpy(ids), torch.from_numpy(label))
    _close(got.logits, want.logits, "logits")
    _close(got.loss, want.loss, "loss")
    bf16 = tce.ClipEndToEnd(dataclasses.replace(CFG, dtype="bfloat16"), num_labels=k,
                            variant=variant, device="cpu").eval()
    bf16.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = bf16(torch.from_numpy(px), torch.from_numpy(ids)).logits
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# ------------------------------------------------------------ the command

def test_precompute_packs_match_the_jax_command_and_direct_towers(tmp_path):
    """Both commands on one jsonl with real PNG files (an odd aspect each),
    a reduced merges file and an OpenAI-layout checkpoint: the same keys and
    the same embeddings (2e-4), and the port's equal to its own towers
    called directly."""
    merges = ttok.build_test_merges(["a", "photo", "of", "cat", "dog", "mat"] * 3)
    vocab_size = 512 + len(merges) + 2
    torch.manual_seed(7)
    ckpt = tmp_path / "tiny_clip.pt"
    torch.save(CLIPTorch(dataclasses.replace(JCFG, vocab_size=vocab_size)).state_dict(),
               str(ckpt))
    bpe = tmp_path / "merges.txt"
    bpe.write_text("#version: test\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    rng = np.random.default_rng(7)
    rows = []
    for i in range(3):
        fn = f"img_{i}.png"
        Image.fromarray(rng.integers(0, 255, size=(40 + 7 * i, 50, 3)).astype(np.uint8)
                        ).save(str(tmp_path / fn))
        rows.append({"img_id": f"img-{i}", "img_fn": fn, "total_id": f"ex-{i}",
                     "objects": ["cat", "dog"],
                     "answer_choices": [["a", "photo", "of", [0]], "a photo of dog",
                                        "dog on mat", [[1], "on", "mat"]]})
    jsonl = tmp_path / "ex.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in rows) + "\n")

    common = ["--checkpoint", str(ckpt), "--bpe_vocab", str(bpe), "--examples_jsonl",
              str(jsonl), "--images_root", str(tmp_path), "--batch", "2", "--tiny",
              "--config_overrides", json.dumps({"vocab_size": vocab_size})]
    packs = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        packs[name] = (str(tmp_path / f"{name}_img.mcrpack"), str(tmp_path / f"{name}_txt.mcrpack"))
        main(common + extra + ["--out_image_pack", packs[name][0],
                               "--out_text_pack", packs[name][1]])

    cfg = dataclasses.replace(CFG, vocab_size=vocab_size)
    model = _port(convert_clip(load_clip_checkpoint(str(ckpt))), cfg)
    tok = ttok.ClipTokenizer(str(bpe))
    for side in (0, 1):
        jpack, tpack = FeatureStore(packs["jax"][side]), FeatureStore(packs["port"][side])
        keys = sorted(tpack.keys())
        assert keys == sorted(jpack.keys()) == \
            ([f"img-{i}" for i in range(3)] if side == 0 else [f"ex-{i}" for i in range(3)])
        for i, key in enumerate(keys):
            got = tpack[key].features
            _close(got, jpack[key].features, key)
            with torch.no_grad():
                if side == 0:
                    px = tpre.preprocess_image(str(tmp_path / f"img_{i}.png"), cfg.image_size)
                    direct = model.encode_image(torch.from_numpy(px[None]))
                else:
                    texts = [tcli.render_plain(c, rows[i]["objects"]) if isinstance(c, list)
                             else c for c in rows[i]["answer_choices"]]
                    ids = tok.tokenize(texts, cfg.context_length, truncate=True)
                    direct = model.encode_text(torch.from_numpy(ids.astype(np.int64)))
            assert got.shape == tuple(direct.shape)
            np.testing.assert_allclose(got, direct.numpy(), rtol=1e-5, atol=1e-5, err_msg=key)
        jpack.close()
        tpack.close()
    assert tcli.render_plain(["a", [0, 5]], ["cat"]) == "a cat and object"


def test_precompute_text_side_needs_the_merges(tmp_path):
    (tmp_path / "e.jsonl").write_text(json.dumps({"img_id": "1", "img_fn": "x.png",
                                                  "answer_choices": ["a"]}) + "\n")
    torch.save(CLIPTorch(JCFG).state_dict(), str(tmp_path / "c.pt"))
    with pytest.raises(SystemExit, match="--bpe_vocab"):
        tcli.main(["--checkpoint", str(tmp_path / "c.pt"), "--examples_jsonl",
                   str(tmp_path / "e.jsonl"), "--out_text_pack", str(tmp_path / "t.mcrpack"),
                   "--tiny", "--device", "cpu"])
