"""The port's TensorBoard event writer (``marconet_tpu_torch/train/
events.py``) read back by TensorBoard's own loader: TFRecord framing and
masked CRC-32C, the ``brain.Event:2`` version record, scalars, PNG images
decoded back to the array, and text."""

import pathlib

import cv2
import numpy as np
import pytest
from tensorboard.backend.event_processing.event_file_loader import (
    LegacyEventFileLoader,
)
from tensorboardX import record_writer as tbx

from marconet_tpu_torch.train import events


@pytest.mark.parametrize("n", [0, 1, 9, 1023, 1024, 1025, 4096, 70001,
                               1_000_003])
def test_crc32c_matches_tensorboardx(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert events.crc32c(data) == tbx.crc32c(data)
    assert events.masked_crc32c(data) == tbx.masked_crc32c(data)


def test_crc32c_check_value():
    assert events.crc32c(b"123456789") == 0xE3069283


def _write(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 70, 3), np.uint8)
    big = rng.integers(0, 256, (128, 600, 3), np.uint8)
    with events.EventWriter(str(tmp_path)) as writer:
        writer.add_scalar("losses/l_g_total", 1.5, 3)
        writer.add_scalar("speed/samples_per_sec", 2.25, 4)
        writer.add_image("val/1_gt_sr_lq", img, 4)
        writer.add_image("val/3_char_prior", big, 4)
        writer.add_text("val/1_pred_text", "字ab", 4)
    return writer.path, img, big


def test_tensorboard_reads_the_file(tmp_path):
    path, img, big = _write(tmp_path)
    assert "events.out.tfevents." in path
    got = list(LegacyEventFileLoader(path).Load())
    assert got[0].file_version == "brain.Event:2"
    values = {v.tag: (e.step, v) for e in got[1:] for v in e.summary.value}
    step, v = values["losses/l_g_total"]
    assert (step, v.simple_value) == (3, 1.5)
    assert values["speed/samples_per_sec"][1].simple_value == 2.25
    for tag, want in (("val/1_gt_sr_lq", img), ("val/3_char_prior", big)):
        step, v = values[tag]
        assert (step, v.image.height, v.image.width, v.image.colorspace) \
            == (4, want.shape[0], want.shape[1], 3)
        decoded = cv2.imdecode(np.frombuffer(v.image.encoded_image_string,
                                             np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(decoded[..., ::-1], want)
    step, v = values["val/1_pred_text"]
    assert v.metadata.plugin_data.plugin_name == "text"
    assert [s.decode() for s in v.tensor.string_val] == ["字ab"]
    assert [d.size for d in v.tensor.tensor_shape.dim] == [1]


def test_read_events_and_scalars(tmp_path):
    path, img, _ = _write(tmp_path)
    evs = events.read_events(path)
    assert evs[0]["file_version"] == "brain.Event:2"
    tags = [v[0] for e in evs for v in e["values"]]
    assert tags == ["losses/l_g_total", "speed/samples_per_sec",
                    "val/1_gt_sr_lq", "val/3_char_prior", "val/1_pred_text"]
    assert events.scalars(str(tmp_path), "speed/samples_per_sec") == \
        [(4, 2.25)]
    assert events.event_files(str(tmp_path)) == [path]


def test_read_records_rejects_damage(tmp_path):
    path, _, _ = _write(tmp_path)
    data = bytearray(pathlib.Path(path).read_bytes())
    data[40] ^= 0x10
    bad = tmp_path / "bad.tfevents"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        list(events.read_records(str(bad)))
    bad.write_bytes(bytes(data[:-3]))
    with pytest.raises(ValueError):
        list(events.read_records(str(bad)))


def test_two_writers_in_one_second_keep_both_files(tmp_path):
    a = events.EventWriter(str(tmp_path))
    b = events.EventWriter(str(tmp_path))
    a.close()
    b.close()
    assert a.path != b.path and len(events.event_files(str(tmp_path))) == 2
