import pytest

from flye_jax.config import Config, setup_run_params


def test_read_type_overlays():
    raw = Config("raw")
    hifi = Config("hifi")
    assert raw.kmer_size == 17 and raw.use_minimizers == 0
    assert hifi.use_minimizers == 1 and hifi.minimizer_window == 10
    assert Config("subasm").kmer_size == 31
    assert isinstance(raw.kmer_size, int)
    assert raw.max_inner_fraction == pytest.approx(0.25)


def test_extra_params_override():
    cfg = Config("raw", extra_params="kmer_size=15, max_separation=100")
    assert cfg.kmer_size == 15
    assert cfg.max_separation == 100


def test_config_save_load(tmp_path):
    cfg = Config("hifi", min_overlap=2000)
    p = str(tmp_path / "cfg.json")
    cfg.save(p)
    back = Config.load(p)
    assert back.read_type == "hifi"
    assert back.min_overlap == 2000
    assert back.minimizer_window == 10


def test_unknown_read_type():
    with pytest.raises(ValueError):
        Config("bogus")


def test_setup_run_params_auto_overlap():
    # N90 of uniform 3500-length reads -> 3500 rounds to 4000
    params = setup_run_params([3500] * 100, "raw", genome_size=10000)
    assert params["min_overlap"] == 4000
    # clamping
    params = setup_run_params([500] * 100, "raw")
    assert params["min_overlap"] == 1000
    params = setup_run_params([9000] * 100, "raw")
    assert params["min_overlap"] == 5000
    # meta cap
    params = setup_run_params([9000] * 100, "raw", meta=True)
    assert params["min_overlap"] == 3000


def test_setup_run_params_downsample():
    lens = [10000] * 50 + [2000] * 50
    params = setup_run_params(lens, "raw", genome_size=10000, asm_coverage=30)
    assert params["min_read_length"] > 0


def test_nano_model_flag_selects_r7():
    """--nano-model r7 routes the polisher to the legacy pore tables
    (reference ships nano_r7 matrices alongside r94,
    flye/config/py_cfg.py:52-67)."""
    from flye_jax.main import RunContext, build_parser
    from flye_jax.polishing.homopolisher import get_hopo_model
    from flye_jax.polishing.matrices import get_subs_matrix

    args = build_parser().parse_args(
        ["--nano-raw", "r.fa", "-o", "/tmp/x", "--nano-model", "r7"])
    ctx = RunContext(args)
    assert ctx.platform == "nano_r7"
    m7 = get_subs_matrix("nano_r7")
    m94 = get_subs_matrix("nano")
    assert m7.shape == (5, 5) and (m7 != m94).any()
    obs, gen = get_hopo_model("nano_r7")
    assert obs.ndim == 3
    # default stays r94
    args = build_parser().parse_args(
        ["--nano-raw", "r.fa", "-o", "/tmp/x"])
    assert RunContext(args).platform == "nano"
