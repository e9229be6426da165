"""ark_tpu_torch.config against ark_tpu.config: the same defaults, and a
PipelineConfig written as JSON by either package reads back equal in the
other (from a string and from a file)."""

import dataclasses

import pytest

from ark_tpu import config as JC
from ark_tpu_torch import config as TC


def _custom(module):
    cfg = module.PipelineConfig(fovs=["fov0", "fov1"], base_dir="/data", img_sub_folder="TIFs")
    cfg.pixel.channels = ["CD3", "CD45"]
    cfg.pixel.som = module.SomConfig(xdim=12, seed=7)
    cfg.cell.som.num_passes = 3
    cfg.segmentation.nuc_channels = ["H3"]
    cfg.spatial.bootstrap_num = 250
    cfg.lda = module.LdaConfig(featurization="marker", radius=50, n_topics=8,
                               difference_penalty=0.5)
    return cfg


def test_defaults_equal():
    assert dataclasses.asdict(TC.PipelineConfig()) == dataclasses.asdict(JC.PipelineConfig())
    assert TC.PipelineConfig().to_json() == JC.PipelineConfig().to_json()
    lda = TC.LdaConfig()
    assert (lda.featurization, lda.radius, lda.train_frac, lda.n_topics,
            lda.difference_penalty, lda.num_boots, lda.seed) == ("cluster", 100, 0.75, 5,
                                                                 0.25, 25, 42)


@pytest.mark.parametrize("writer,reader", [(JC, TC), (TC, JC), (TC, TC)])
def test_json_round_trips_across_packages(tmp_path, writer, reader):
    cfg = _custom(writer)
    text = cfg.to_json()
    assert text == _custom(reader).to_json()
    back = reader.PipelineConfig.from_json(text)
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert isinstance(back.pixel.som, reader.SomConfig)
    assert isinstance(back.lda, reader.LdaConfig)
    path = tmp_path / "cfg.json"
    assert cfg.to_json(str(path)) == path.read_text()
    assert reader.PipelineConfig.from_json(str(path)).to_json() == text
