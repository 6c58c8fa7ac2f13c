"""The port's config system and arch registry against the reference's: the
same dataclasses, the same ten architectures and smoke configs, the same
parameter counts, shapes and JSON."""
import dataclasses

import pytest

from repro import configs as ref_configs
from repro.core import config as ref_config
from repro_torch import configs
from repro_torch.core import config


def test_registry_names_match_reference():
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert set(configs.all_configs()) == set(ref_configs.all_configs())


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ref_configs.ARCH_NAMES)
def test_config_matches_reference(arch, smoke):
    get, ref_get = ((configs.get_smoke_config, ref_configs.get_smoke_config)
                    if smoke else (configs.get_config, ref_configs.get_config))
    cfg, want = get(arch), ref_get(arch)
    assert isinstance(cfg, config.ArchConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.param_count() == want.param_count()
    assert cfg.active_param_count() == want.active_param_count()
    assert (cfg.head_dim_, cfg.is_encdec) == (want.head_dim_, want.is_encdec)
    assert config.to_json(cfg) == ref_config.to_json(want)


@pytest.mark.parametrize("shape", [s.name for s in ref_config.SHAPES])
def test_get_shape_matches_reference(shape):
    got, want = config.get_shape(shape), ref_config.get_shape(shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.tokens == want.tokens


def test_unknown_names_raise_like_reference():
    with pytest.raises(KeyError):
        config.get_shape("nope")
    with pytest.raises(KeyError):
        configs.get_config("nope")


def test_run_config_and_replace_match_reference():
    assert config.to_json(config.RunConfig()) == \
        ref_config.to_json(ref_config.RunConfig())
    cfg = config.replace(configs.get_config("qwen2-1.5b"), n_layers=4)
    want = ref_config.replace(ref_configs.get_config("qwen2-1.5b"),
                              n_layers=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.param_count() == want.param_count()


def test_qwen2_full_width():
    """The arch the model path runs at full width on the card."""
    cfg = configs.get_config("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab) == \
        (28, 1536, 12, 2, 128, 8960, 151936)
    assert cfg.tie_embeddings and cfg.attn.qkv_bias
    assert cfg.param_count() == 1_543_714_304
