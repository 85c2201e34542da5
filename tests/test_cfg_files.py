"""Reference-format .cfg parsing (key = value, #comments, %include)."""

import os

import pytest

from flye_jax.config.params import Config, load_cfg_file


def write(tmp_path, name, text):
    p = os.path.join(tmp_path, name)
    with open(p, "w") as f:
        f.write(text)
    return p


def test_cfg_include_chain(tmp_path):
    tmp = str(tmp_path)
    write(tmp, "base.cfg", "# base\nkmer_size = 15\nmaximum_jump = 1000\n")
    top = write(tmp, "top.cfg",
                "%include base.cfg\n\n#override\nkmer_size = 17\n"
                "assemble_ovlp_divergence = 0.10\n")
    vals = load_cfg_file(top)
    assert vals == {"kmer_size": 17.0, "maximum_jump": 1000.0,
                    "assemble_ovlp_divergence": 0.10}


def test_cfg_layers_over_defaults_and_extra_wins(tmp_path):
    top = write(str(tmp_path), "t.cfg", "kmer_size = 19\n")
    cfg = Config.from_cfg(top, read_type="raw",
                          extra_params="kmer_size=21,maximum_jump=900")
    assert cfg.kmer_size == 21          # extra-params beat the file
    assert cfg.maximum_jump == 900
    assert "max_bubble_length" in cfg   # defaults still present


def test_cfg_bad_line_raises(tmp_path):
    p = write(str(tmp_path), "bad.cfg", "kmer_size 17\n")
    with pytest.raises(ValueError):
        load_cfg_file(p)
