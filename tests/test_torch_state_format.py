"""JAX's checkpoint-frame cases (``tests/checkpointing/test_state_format.py``:
the CRC32 footer, the retention ring, the corrupt-generation fallback,
config binding, legacy frames, the record-class header, orphaned temp
files) run against the port's ``checkpointing/state.py``; and frames cross
between the packages: JAX's ``read_frame`` reads the port's frames and the
port's reads JAX's, headers and meta equal (the bytes too, at one clock),
and each package's ``StateCheckpointer`` loads the other's ring."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import json
import os
import zlib

import numpy as np
import pytest

from fl4health_tpu.checkpointing import state as jstate
from fl4health_tpu.server.simulation import RoundRecord as JRoundRecord
from fl4health_tpu_torch.checkpointing import serialization
from fl4health_tpu_torch.checkpointing import state as tstate
from fl4health_tpu_torch.checkpointing.state import (
    CheckpointConfigMismatchError,
    CheckpointCorruptError,
    DataclassListSnapshotter,
    StateCheckpointer,
)
from fl4health_tpu_torch.server.simulation import RoundRecord

TREES = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
         "nested": {"b": np.float32(3.5)}}
TEMPLATES = {"w": np.zeros((2, 3), np.float32),
             "nested": {"b": np.float32(0.0)}}


def _save(ck, value=0.0, rnd=1):
    trees = {"w": TREES["w"] + value, "nested": {"b": np.float32(value)}}
    return ck.save(trees, host={"round": rnd}, extra_meta={"round": rnd})


class TestFrameFormat:
    def test_roundtrip_trees_host_and_meta(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), config_hash="abc123")
        stats = _save(ck, 2.0, rnd=7)
        assert stats["generation"] == 1
        assert stats["bytes"] == os.path.getsize(stats["path"])
        trees, host, info = ck.load_with_info(TEMPLATES, {"round": 0})
        np.testing.assert_array_equal(trees["w"], TREES["w"] + 2.0)
        assert host["round"] == 7
        assert info.meta["config_hash"] == "abc123"
        assert info.meta["format_version"] == 1
        assert info.generation == 1
        assert info.fallback_skipped == []

    def test_crc_covers_the_whole_body(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path))
        path = _save(ck)["path"]
        with open(path, "rb") as f:
            data = f.read()
        body, crc = data[:-4], int.from_bytes(data[-4:], "big")
        assert (zlib.crc32(body) & 0xFFFFFFFF) == crc

    def test_legacy_frame_still_loads(self, tmp_path):
        """Pre-ring checkpoints ([8B len][header][blob], no magic/CRC) load
        as format version 0."""
        legacy = tmp_path / "state.ckpt"
        header = json.dumps({"round": 3}).encode()
        blob = serialization.to_bytes(dict(TREES))
        legacy.write_bytes(len(header).to_bytes(8, "big") + header + blob)
        ck = StateCheckpointer(str(tmp_path))
        assert ck.exists()
        trees, host, info = ck.load_with_info(TEMPLATES, {"round": 0})
        assert host["round"] == 3
        assert info.generation == 0
        assert info.meta["format_version"] == 0
        np.testing.assert_array_equal(trees["w"], TREES["w"])

    def test_newer_format_version_is_a_typed_error(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), keep=1)
        path = _save(ck)["path"]
        data = bytearray(open(path, "rb").read())
        data[8:12] = (99).to_bytes(4, "big")  # bump the version field
        body = bytes(data[:-4])
        data[-4:] = (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "big")
        open(path, "wb").write(bytes(data))
        with pytest.raises(CheckpointCorruptError, match="version 99"):
            ck.load(TEMPLATES)


class TestCorruptionDetection:
    def test_truncation_raises_typed_error_naming_the_file(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), keep=1)
        path = _save(ck)["path"]
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
        with pytest.raises(CheckpointCorruptError) as ei:
            ck.load(TEMPLATES)
        assert path in str(ei.value)
        assert ei.value.path == path

    def test_bit_flip_caught_by_crc(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), keep=1)
        path = _save(ck)["path"]
        data = bytearray(open(path, "rb").read())
        i = len(data) // 2
        data[i] ^= 0xFF
        open(path, "wb").write(bytes(data))
        with pytest.raises(CheckpointCorruptError, match="CRC32"):
            ck.load(TEMPLATES)

    def test_tiny_torn_file_is_corrupt_not_a_crash(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), keep=1)
        path = _save(ck)["path"]
        open(path, "wb").write(b"FL4HCKPT\x00")
        with pytest.raises(CheckpointCorruptError, match="truncated"):
            ck.load(TEMPLATES)


class TestRetentionRing:
    def test_ring_keeps_last_k_with_monotonic_generations(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), keep=3)
        for r in range(1, 6):
            _save(ck, float(r), rnd=r)
        gens = ck.generations()
        assert [g for g, _ in gens] == [3, 4, 5]
        trees, host = ck.load(TEMPLATES, {"round": 0})
        assert host["round"] == 5
        np.testing.assert_array_equal(trees["w"], TREES["w"] + 5.0)

    def test_corrupt_newest_falls_back_to_previous_good(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), keep=3)
        for r in (1, 2, 3):
            _save(ck, float(r), rnd=r)
        newest = ck.candidate_paths()[0][1]
        data = open(newest, "rb").read()
        open(newest, "wb").write(data[:100])  # torn tail
        trees, host, info = ck.load_with_info(TEMPLATES, {"round": 0})
        assert host["round"] == 2  # the previous generation won
        np.testing.assert_array_equal(trees["w"], TREES["w"] + 2.0)
        assert info.fallback_skipped == [newest]

    def test_all_generations_corrupt_raises_newest_error(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), keep=2)
        _save(ck, 1.0)
        _save(ck, 2.0)
        paths = [p for _g, p in ck.candidate_paths()]
        for p in paths:
            open(p, "wb").write(b"garbage")
        with pytest.raises(CheckpointCorruptError) as ei:
            ck.load(TEMPLATES)
        assert ei.value.path == paths[0]

    def test_keep_one_has_no_fallback_but_still_detects(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), keep=1)
        _save(ck, 1.0)
        _save(ck, 2.0)
        assert len(ck.generations()) == 1
        newest = ck.candidate_paths()[0][1]
        open(newest, "wb").write(b"garbage")
        with pytest.raises(CheckpointCorruptError):
            ck.load(TEMPLATES)

    def test_clear_removes_every_generation(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path), keep=3)
        _save(ck, 1.0)
        _save(ck, 2.0)
        assert ck.exists()
        ck.clear()
        assert not ck.exists()

    def test_validation(self, tmp_path):
        with pytest.raises(ValueError, match="keep"):
            StateCheckpointer(str(tmp_path), keep=0)
        with pytest.raises(ValueError, match="checkpoint_every"):
            StateCheckpointer(str(tmp_path), checkpoint_every=0)


class TestConfigBinding:
    def test_mismatched_config_hash_rejected(self, tmp_path):
        writer = StateCheckpointer(str(tmp_path), config_hash="exp-A")
        _save(writer)
        reader = StateCheckpointer(str(tmp_path), config_hash="exp-B")
        with pytest.raises(CheckpointConfigMismatchError, match="exp-A"):
            reader.load(TEMPLATES, expected_config_hash="exp-B")

    def test_matching_or_absent_hash_accepted(self, tmp_path):
        writer = StateCheckpointer(str(tmp_path), config_hash="exp-A")
        _save(writer)
        reader = StateCheckpointer(str(tmp_path))
        reader.load(TEMPLATES, expected_config_hash="exp-A")  # match
        reader.load(TEMPLATES)  # no expectation: legacy callers
        # legacy frames (no stored hash) never hard-fail the check
        unhashed = StateCheckpointer(str(tmp_path / "u"))
        _save(unhashed)
        unhashed.load(TEMPLATES, expected_config_hash="anything")


class TestOnSaveHook:
    def test_stats_reported_and_hook_failure_swallowed(self, tmp_path):
        seen = []

        def hook(stats):
            seen.append(stats)
            raise RuntimeError("metrics hook bug")  # must not kill the save

        ck = StateCheckpointer(str(tmp_path), on_save=hook)
        stats = _save(ck, rnd=4)
        assert os.path.exists(stats["path"])
        assert seen[0]["generation"] == 1
        assert seen[0]["round"] == 4
        assert seen[0]["bytes"] > 0
        assert seen[0]["write_s"] >= 0


class TestDataclassListSnapshotter:
    RECORDS = [
        RoundRecord(1, {"backward": 0.5}, {}, {"checkpoint": 0.4}, {},
                    1.0, 0.1),
        RoundRecord(2, {"backward": 0.3}, {}, {"checkpoint": 0.2}, {},
                    1.1, 0.1),
    ]

    def test_empty_template_restores_real_records(self, tmp_path):
        """THE satellite fix: a non-empty payload loaded against an empty
        template must come back as RoundRecords (class name rides the
        header), never raw dicts."""
        snap = DataclassListSnapshotter()
        payload = json.loads(json.dumps(snap.save(self.RECORDS)))
        restored = snap.load(payload, [])
        assert all(isinstance(r, RoundRecord) for r in restored)
        assert restored == self.RECORDS

    def test_legacy_bare_list_payload_with_template(self):
        snap = DataclassListSnapshotter()
        legacy_payload = [dataclasses_asdict(r) for r in self.RECORDS]
        restored = snap.load(legacy_payload, [RoundRecord(0, {}, {}, {}, {},
                                                          0.0, 0.0)])
        assert restored == self.RECORDS

    def test_legacy_bare_list_without_template_degrades_to_dicts(self):
        snap = DataclassListSnapshotter()
        legacy_payload = [dataclasses_asdict(r) for r in self.RECORDS]
        restored = snap.load(legacy_payload, [])
        assert isinstance(restored[0], dict)

    def test_unresolvable_class_degrades_to_dicts(self):
        snap = DataclassListSnapshotter()
        payload = {"rows": [{"a": 1}], "record_class": "no.such.module:X"}
        assert snap.load(payload, []) == [{"a": 1}]

    def test_empty_everything(self):
        snap = DataclassListSnapshotter()
        assert snap.load(None, []) == []
        assert snap.load({"rows": []}, []) == []
        assert snap.load([], []) == []

    def test_full_frame_roundtrip_with_empty_template(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path))
        ck.save({"w": np.zeros(2, np.float32)},
                host={"history": self.RECORDS},
                snapshotters={"history": DataclassListSnapshotter()})
        _trees, host = ck.load(
            {"w": np.zeros(2, np.float32)}, {"history": []},
            snapshotters={"history": DataclassListSnapshotter()},
        )
        assert host["history"] == self.RECORDS
        assert all(isinstance(r, RoundRecord) for r in host["history"])


def dataclasses_asdict(r):
    import dataclasses

    return dataclasses.asdict(r)


class TestOrphanTmpCleanup:
    def test_save_sweeps_mid_write_litter(self, tmp_path):
        """A SIGKILL mid-write leaves `<frame>.tmp.<pid>` litter that
        atomic_write cannot unlink; the next successful save prunes it
        (and clear() does too) so a preemptible job's checkpoint dir
        cannot grow without bound."""
        ck = StateCheckpointer(str(tmp_path), keep=2)
        _save(ck, 1.0)
        orphan = tmp_path / "state.g00000099.ckpt.tmp.12345"
        orphan.write_bytes(b"torn")
        legacy_orphan = tmp_path / "state.ckpt.tmp.777"
        legacy_orphan.write_bytes(b"torn")
        unrelated = tmp_path / "notes.txt"
        unrelated.write_text("keep me")
        _save(ck, 2.0)
        assert not orphan.exists()
        assert not legacy_orphan.exists()
        assert unrelated.exists()

    def test_clear_removes_orphans_too(self, tmp_path):
        ck = StateCheckpointer(str(tmp_path))
        _save(ck, 1.0)
        orphan = tmp_path / "state.g00000002.ckpt.tmp.1"
        orphan.write_bytes(b"torn")
        ck.clear()
        assert not ck.exists()
        assert not orphan.exists()


class TestJaxRecordClass:
    def test_jax_record_class_is_not_imported(self, tmp_path, monkeypatch):
        """A frame written by JAX names ``fl4health_tpu.server.simulation:
        RoundRecord``: the port never imports it, and falls back to its
        template (the simulation's loaders pass one)."""
        import importlib

        seen = []
        real = importlib.import_module
        monkeypatch.setattr(tstate.importlib, "import_module",
                            lambda name, *a: seen.append(name) or real(name, *a))
        rec = JRoundRecord(1, {"backward": 0.5}, {}, {"checkpoint": 0.4}, {}, 1.0, 0.1)
        payload = json.loads(json.dumps(jstate.DataclassListSnapshotter().save([rec])))
        assert payload["record_class"] == "fl4health_tpu.server.simulation:RoundRecord"
        snap = DataclassListSnapshotter()
        assert snap.load(payload, []) == [dataclasses_asdict(rec)]
        restored = snap.load(payload, [RoundRecord(0, {}, {}, {}, {}, 0.0, 0.0)])
        assert restored == [RoundRecord(**dataclasses_asdict(rec))]
        assert not any(n.startswith("fl4health_tpu.") or n == "fl4health_tpu" for n in seen)


HISTORY = [{"round": 1, "fit_losses": {"backward": 0.5}, "fit_metrics": {},
            "eval_losses": {"checkpoint": 0.4}, "eval_metrics": {"accuracy": 0.25},
            "fit_elapsed_s": 1.0, "eval_elapsed_s": 0.1}]


def _frame_args():
    trees = {"server_state": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                              "count": np.array(3, np.int32)},
             "client_states": {"rng": np.array([[0, 7], [0, 9]], np.uint32),
                               "mask": np.array([True, False])}}
    host = {"kind": "sync", "current_round": 2, "n_clients": 2,
            "history": {"rows": HISTORY, "record_class": "x:RoundRecord"}}
    meta = {"config_hash": "0123456789abcdef", "round": 2, "kind": "sync"}
    return trees, host, meta


@pytest.mark.parametrize("writer,reader", [(tstate, jstate), (jstate, tstate)],
                         ids=["port_to_jax", "jax_to_port"])
def test_frames_cross_read(tmp_path, monkeypatch, writer, reader):
    trees, host, meta = _frame_args()
    path = str(tmp_path / "state.g00000001.ckpt")
    writer.write_frame(path, trees, host_header=host, meta=meta)
    got_host, got_meta, blob = reader.read_frame(path)
    assert got_host == host
    assert {k: v for k, v in got_meta.items() if k != "saved_unix"} == {
        "format_version": 1, **meta}
    restored = serialization.msgpack_restore(blob)
    for name, tree in trees.items():
        for k, v in tree.items():
            assert restored[name][k].dtype == v.dtype
            np.testing.assert_array_equal(restored[name][k], v)


def test_frame_bytes_equal_at_one_clock(tmp_path, monkeypatch):
    trees, host, meta = _frame_args()
    monkeypatch.setattr(jstate.time, "time", lambda: 1.5e9)
    monkeypatch.setattr(tstate.time, "time", lambda: 1.5e9)
    jp, tp = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jstate.write_frame(jp, trees, host_header=host, meta=meta)
    tstate.write_frame(tp, trees, host_header=host, meta=meta)
    assert open(jp, "rb").read() == open(tp, "rb").read()


@pytest.mark.parametrize("writer,reader", [(jstate, tstate), (tstate, jstate)],
                         ids=["jax_ring_to_port", "port_ring_to_jax"])
def test_rings_cross_load(tmp_path, writer, reader):
    w = writer.StateCheckpointer(str(tmp_path), keep=2, config_hash="exp")
    for r in (1, 2, 3):
        w.save({"w": TREES["w"] + r, "nested": {"b": np.float32(r)}}, host={"round": r},
               extra_meta={"round": r})
    trees, host, info = reader.StateCheckpointer(str(tmp_path)).load_with_info(
        TEMPLATES, {"round": 0}, expected_config_hash="exp")
    assert host["round"] == 3 and info.generation == 3
    np.testing.assert_array_equal(trees["w"], TREES["w"] + 3)
