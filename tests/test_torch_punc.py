"""The port's punctuation against the JAX package on the CPU: the
CT-Transformer with and without the VadMask, the tokenizer, and the
offline and streaming passes of Punctuator.

Weights come from the JAX `init` of punc_tiny (d=32, 2 blocks, 2 heads),
carried across with `params_from_jax`. Logits are held to rtol/atol
1e-4 (a whole model); token ids and text must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import ct_transformer as jct
from asr2pass_tpu.runtime.punc import Punctuator as JPunctuator
from asr2pass_tpu.text.punc_tokenizer import PuncTokenizer as JTokenizer
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.models import ct_transformer as tct
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.runtime.punc import Punctuator as TPunctuator
from asr2pass_tpu_torch.text import punc_tokenizer as tpt
from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer as TTokenizer
from torch_parity import ragged_mask, t

TOL = dict(rtol=1e-4, atol=1e-4)
TOKENS = (["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(200)]
          + ["hello", "world", "the", "asr", "一丁", "七万丈"])


@pytest.fixture(scope="module")
def punc():
    jcfg = jconfig.punc_tiny(vocab_size=300)
    tcfg = tconfig.punc_tiny(vocab_size=300)
    tree = jax.tree.map(np.asarray, jct.init(jax.random.PRNGKey(0), jcfg))
    sd = params_from_jax(tree)
    return jcfg, tcfg, tree, sd, tct.from_state_dict(sd, tcfg, device="cpu")


def test_punc_config_copies():
    assert (dataclasses.asdict(tconfig.punc_tiny())
            == dataclasses.asdict(jconfig.punc_tiny()))
    assert (dataclasses.asdict(tconfig.PuncConfig())
            == dataclasses.asdict(jconfig.PuncConfig()))
    cfg = tconfig.PuncConfig()
    assert (cfg.embed_dim, cfg.att_dim, cfg.num_blocks,
            cfg.attention_heads) == (256, 256, 4, 8)


@pytest.mark.parametrize("vad_pos", [None, 0, 7])
def test_ct_transformer_apply(punc, vad_pos):
    """A ragged batch of ids; with a VadMask at position 7 (and the no-op
    mask at 0) and with none."""
    jcfg, tcfg, tree, _, model = punc
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 300, (2, 20))
    lens = np.array([20, 13])
    am = None if vad_pos is None else tct.vad_mask(20, vad_pos)
    if am is not None:
        np.testing.assert_array_equal(am, jct.vad_mask(20, vad_pos))
    ref = jct.apply(tree, jcfg, jnp.asarray(ids), jnp.asarray(lens),
                    None if am is None else jnp.asarray(am))
    got = tct.apply(model, tcfg, torch.as_tensor(ids), torch.as_tensor(lens),
                    None if am is None else t(am))
    valid = ragged_mask(lens, 20)[..., None] > 0
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0),
                               np.where(valid, np.asarray(ref), 0), **TOL)


@pytest.mark.parametrize("text", [
    "hello world" + chr(0x4E00) + chr(0x4E01),
    "xyzzy the ASR 七万丈一丁丁 hello",
    "",
    "  一  丁 ",
])
def test_tokenizer(text):
    """Ascii words, greedy longest vocabulary match, per-char fallback,
    the unknown id and the lower-case lookup."""
    jt, tt = JTokenizer(TOKENS), TTokenizer(TOKENS)
    assert tt.tokenize(text) == jt.tokenize(text)
    assert [tt.id2punc(i) for i in range(-1, 8)] == \
        [jt.id2punc(i) for i in range(-1, 8)]
    assert tpt.DEFAULT_PUNC_LIST == ["<unk>", "_", "，", "。", "？", "、"]


def _punctuators(punc):
    jcfg, tcfg, tree, sd, _ = punc
    return (JPunctuator(tree, jcfg, JTokenizer(TOKENS)),
            TPunctuator(sd, tcfg, TTokenizer(TOKENS), device="cpu"))


def _text(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(chr(0x4E00 + int(i)) for i in rng.integers(0, 150, n))


@pytest.mark.parametrize("lang", ["zh", "en-bpe"])
def test_add_punc(punc, lang):
    """Offline: one window, several 20-token windows with the carry, and
    mixed ascii words."""
    jp, tp = _punctuators(punc)
    for text in (_text(9, 2), _text(55, 3), _text(130, 4),
                 "hello world " + _text(12, 5) + " the asr"):
        ref = jp.add_punc(text, lang)
        assert tp.add_punc(text, lang) == ref
        assert ref


def test_add_punc_streaming(punc):
    """Streaming: a run of finals through one cache, as a session sends
    them; the cache after each call is equal too."""
    jp, tp = _punctuators(punc)
    jcache, tcache = [], []
    for i, n in enumerate((10, 8, 27, 3, 45, 0)):
        text = _text(n, 10 + i) + ("hello" if i == 3 else "")
        ref = jp.add_punc_streaming(text, jcache)
        assert tp.add_punc_streaming(text, tcache) == ref
        assert tcache == jcache


def test_punc_dir_round_trip(punc, tmp_path):
    """A punctuation dir the port writes loads in the JAX package
    (load_punc_dir) with the same tree, configuration and tokenizer, and
    back in the port with the same state dict."""
    from asr2pass_tpu.runtime.model_zoo import load_punc_dir as jload
    from asr2pass_tpu_torch.runtime import model_zoo as tzoo

    _, tcfg, tree, sd, model = punc
    punc_list = ["<unk>", "_", "，", "。", "？", "、", "！"]
    cfg = dataclasses.replace(tcfg, num_classes=len(punc_list))
    tzoo.save_punc_dir(str(tmp_path), model, cfg, TOKENS[:300], punc_list)
    jtree, jcfg, jtok = jload(str(tmp_path))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert jtok.punc_list == punc_list and jtok.token2id == TTokenizer(
        TOKENS[:300]).token2id
    np.testing.assert_array_equal(jtree["embed"]["table"],
                                  tree["embed"]["table"])
    np.testing.assert_array_equal(jtree["encoder"]["rest"]["att"]["qkv"]["w"],
                                  tree["encoder"]["rest"]["att"]["qkv"]["w"])
    got_sd, got_cfg, got_tok = tzoo.load_punc_dir(str(tmp_path))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    assert got_tok.punc_list == punc_list
    assert got_sd.keys() == sd.keys()
    assert all(torch.equal(got_sd[k], v) for k, v in sd.items())


def test_punc_yaml_loader_matches(tmp_path):
    """FunASR's punctuation config.yaml keys (sanm_shfit spelling, an
    embedded token_list, punc_list) read the same in both packages."""
    path = tmp_path / "config.yaml"
    path.write_text(
        "encoder_conf: {output_size: 64, attention_heads: 4, num_blocks: 3,"
        " linear_units: 128, kernel_size: 5, sanm_shfit: 1}\n"
        "token_list: [a, b, c, d]\n"
        "punc_list: ['<unk>', '_', x, y]\n")
    assert (dataclasses.asdict(tconfig.load_punc_yaml(str(path)))
            == dataclasses.asdict(jconfig.load_punc_yaml(str(path))))
