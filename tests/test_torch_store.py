"""Port parity: the LogitStore v2 (``store/``) against the JAX reference.

The same numpy (vals, idx, lens) go through the reference's
``LogitStoreV2`` and the port's: the shard ``.npy`` files and
``manifest.json`` must be byte-identical.  Each package opens, verifies
and reads the other's root and migrates the other's v1 store.  The
reference's own store cases (``tests/test_store.py``) run against both
packages side by side, each case asserting the reference's behaviour
and both leaving the same bytes on disk.
"""
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.store as jstore  # noqa: E402
import repro_torch.store as pstore  # noqa: E402
from repro.core.logit_store import LogitStore as JaxV1  # noqa: E402
from repro_torch.core.logit_store import LogitStore as PortV1  # noqa: E402

PKGS = {"jax": SimpleNamespace(store=jstore, V1=JaxV1),
        "port": SimpleNamespace(store=pstore, V1=PortV1)}
K, V = 4, 50


def _shard(seed=0, b=2, s=6, k=K, v=V):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(b, s, k)).astype(np.float32)
    vals = vals - vals.max(-1, keepdims=True)
    idx = rng.integers(0, v, (b, s, k)).astype(np.int32)
    return vals, idx


def _files(root) -> dict:
    """{relpath: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _manifest(root) -> dict:
    with open(os.path.join(root, "manifest.json")) as f:
        return json.load(f)


# ------------------------------------------------------------ bitwise writes

@pytest.mark.parametrize("inputs", ["numpy", "bf16_tensors", "f32_tensors"])
def test_writes_are_byte_identical(inputs, tmp_path):
    """Three shards over two waves, with ragged lens, a frame-only shard
    (no lens) and f16 overflow / underflow values: the port's files and
    manifest equal the reference's byte for byte.  Tensors (the
    engine's bf16 output, or float32) write what the reference writes
    for the same values."""
    shards = []
    for j in range(3):
        v, i = _shard(20 + j)
        v[0, 0, :3] = [0.0, -1e-9, -70000.0]
        shards.append((j, v, i, [6, 4] if j != 1 else None))
    roots = {name: str(tmp_path / name) for name in PKGS}
    for name, pkg in PKGS.items():
        st = pkg.store.LogitStoreV2(roots[name], k=K, vocab=V)
        for wave in (0, 1):
            for j, v, i, lens in shards:
                if inputs != "numpy" and name == "port":
                    dt = (torch.bfloat16 if inputs == "bf16_tensors"
                          else torch.float32)
                    v, i = torch.from_numpy(v).to(dt), torch.from_numpy(i)
                elif inputs == "bf16_tensors":
                    v = jnp.asarray(v, jnp.bfloat16)
                with np.errstate(over="ignore"):
                    st.append_shard(j, v, i, lens, wave=wave)
        st.gc()
    jf, pf = _files(roots["jax"]), _files(roots["port"])
    assert sorted(jf) == sorted(pf) and len(jf) == 1 + 3 * 3
    for rel in jf:
        assert jf[rel] == pf[rel], rel
    assert _manifest(roots["jax"]) == _manifest(roots["port"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_store(writer, tmp_path):
    root = str(tmp_path / "s")
    w = PKGS[writer].store.LogitStoreV2(root, k=K, vocab=V)
    for j in range(3):
        w.append_shard(j, *_shard(30 + j), utt_lens=[6, 6])
    w.append_shard(1, *_shard(40), utt_lens=[5, 6], wave=1)
    readers = {n: p.store.LogitStoreV2(root) for n, p in PKGS.items()}
    for n, r in readers.items():
        assert r.verify() == 3 and r.shards() == [0, 1, 2]
        assert (r.k, r.vocab, r.next_wave()) == (K, V, 2)
        assert r.stats().n_frames == 36
    jr, pr = readers["jax"], readers["port"]
    for j in range(3):
        jv, ji = jr.read_shard(j, verify=True)
        pv, pi = pr.read_shard(j, verify=True)
        assert isinstance(pv, np.memmap) and pv.dtype == np.float16
        assert pi.dtype == np.int32
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pr.read_lens(j), jr.read_lens(j))
        pe, je = pr.manifest.entry(j), jr.manifest.entry(j)
        assert pe.to_json() == je.to_json()
        np.testing.assert_array_equal(pr.read_entry(pe)[1],
                                      jr.read_entry(je)[1])


@pytest.mark.filterwarnings("ignore:overflow encountered in cast")
@pytest.mark.parametrize("v1_writer", ["jax", "port"])
@pytest.mark.parametrize("migrator", ["jax", "port"])
def test_v1_migration_and_supersede(v1_writer, migrator, tmp_path):
    """A v1 archive written by either package migrates in place through
    either package's ``migrate_v1`` (the same manifest as the other
    package's migration of a copy), reads and verifies through both, and
    a new wave supersedes shard 1 into v2 files, retiring its npz."""
    src = str(tmp_path / "v1")
    v1 = PKGS[v1_writer].V1(src, k=K, vocab=V)
    shards = {j: _shard(10 + j) for j in range(3)}
    for j, (v, i) in shards.items():
        v1.write_shard(j, v, i, utt_lens=[6, 6])
    roots = {}
    for n in PKGS:
        roots[n] = str(tmp_path / f"m_{n}")
        shutil.copytree(src, roots[n])
    store = PKGS[migrator].store.migrate_v1(roots[migrator])
    other = "port" if migrator == "jax" else "jax"
    PKGS[other].store.migrate_v1(roots[other])
    assert _manifest(roots["jax"]) == _manifest(roots["port"])
    assert store.k == K and store.vocab == V and store.verify() == 3
    for n, p in PKGS.items():
        reread = p.store.LogitStoreV2(roots[migrator])
        assert reread.verify() == 3
        for j, (v, i) in shards.items():
            got_v, got_i = reread.read_shard(j)
            assert reread.manifest.entry(j).format == "v1-npz"
            assert got_v.dtype == np.float16 and got_i.dtype == np.int32
            np.testing.assert_array_equal(got_i, i)
            np.testing.assert_allclose(got_v.astype(np.float32), v,
                                       atol=1e-2)
            np.testing.assert_array_equal(reread.read_lens(j), [6, 6])
    v_new, i_new = _shard(99)
    store.append_shard(1, v_new, i_new, wave=1)
    entry = store.manifest.entry(1)
    assert entry.format == "v2" and entry.wave == 1
    npz = os.path.join(roots[migrator], "shard_00001.npz")
    assert os.path.exists(npz)
    PKGS[other].store.LogitStoreV2(roots[migrator])       # gc on open
    assert not os.path.exists(npz)
    np.testing.assert_array_equal(store.read_shard(1, verify=True)[1], i_new)
    assert store.verify() == 3


def test_storage_math_matches_jax():
    for k in (1, 20):
        assert pstore.storage_bytes_per_frame(k) == \
            jstore.storage_bytes_per_frame(k)
    assert pstore.full_bytes_per_frame(3183) == \
        jstore.full_bytes_per_frame(3183) == 12732
    assert sorted(pstore.__all__) == sorted(jstore.__all__)
    with pytest.raises(AttributeError):
        pstore.no_such_name  # noqa: B018


# ------------------------------------------- the reference's store cases

def case_roundtrip(s, root):
    store = s.LogitStoreV2(root, k=K, vocab=V)
    vals, idx = _shard(0)
    store.append_shard(0, vals, idx, utt_lens=[6, 6])
    v, i = store.read_shard(0)
    np.testing.assert_array_equal(i, idx)
    np.testing.assert_allclose(np.asarray(v, np.float32), vals, atol=1e-2)
    np.testing.assert_array_equal(store.read_lens(0), [6, 6])
    meta = store.stats()
    assert (meta.n_frames, meta.k, meta.vocab) == (12, K, V)
    again = s.LogitStoreV2(root)
    assert again.shards() == [0] and (again.k, again.vocab) == (K, V)
    assert isinstance(v, np.memmap) and isinstance(i, np.memmap)


def case_k_vocab_mismatch(s, root):
    s.LogitStoreV2(root, k=K, vocab=V).append_shard(0, *_shard(0))
    with pytest.raises(s.StoreError):
        s.LogitStoreV2(root, k=8, vocab=V)
    with pytest.raises(s.StoreError):
        s.LogitStoreV2(root, k=K, vocab=99)


def case_corrupted_shard(s, root):
    store = s.LogitStoreV2(root, k=K, vocab=V)
    store.append_shard(0, *_shard(2))
    store.verify()
    path = os.path.join(root, store.manifest.entry(0).files["vals"])
    with open(path, "r+b") as f:                # flip bytes past the header
        f.seek(os.path.getsize(path) - 4)
        f.write(b"\xff\xff\xff\xff")
    fresh = s.LogitStoreV2(root)
    with pytest.raises(s.ShardCorruptionError):
        fresh.read_shard(0, verify=True)
    with pytest.raises(s.ShardCorruptionError):
        fresh.verify()
    fresh.read_shard(0)                         # unverified read still works


def case_atomic_supersede(s, root):
    store = s.LogitStoreV2(root, k=K, vocab=V)
    v0, i0 = _shard(3)
    store.append_shard(0, v0, i0)
    old_files = dict(store.manifest.entry(0).files)
    v1_, i1_ = _shard(4)
    staged = store._write_shard_files(0, v1_, i1_, wave=1)
    reader = s.LogitStoreV2(root, gc_on_open=False)
    np.testing.assert_array_equal(reader.read_shard(0, verify=True)[1], i0)
    assert reader.manifest.entry(0).wave == 0
    store._commit(staged)
    reader2 = s.LogitStoreV2(root, gc_on_open=False)
    np.testing.assert_array_equal(reader2.read_shard(0, verify=True)[1],
                                  i1_)
    assert reader2.manifest.entry(0).wave == 1
    for rel in old_files.values():
        assert os.path.exists(os.path.join(root, rel))
    assert sorted(store.gc()) == sorted(old_files.values())
    for rel in old_files.values():
        assert not os.path.exists(os.path.join(root, rel))
    assert s.LogitStoreV2(root).manifest.retired == []


def case_stale_wave(s, root):
    store = s.LogitStoreV2(root, k=K, vocab=V)
    v, i = _shard(5)
    store.append_shard(0, v, i, wave=2)
    with pytest.raises(s.StaleWaveError):
        store.append_shard(0, v, i, wave=1)
    store.append_shard(0, v, i, wave=2)         # idempotent same-wave retry
    store.verify()
    assert store.next_wave() == 3


def case_garbage_tmp_manifest(s, root):
    store = s.LogitStoreV2(root, k=K, vocab=V)
    store.append_shard(0, *_shard(0))
    with open(s.Manifest.path_for(root) + ".tmp", "w") as f:
        f.write("{not json")
    assert s.LogitStoreV2(root).shards() == [0]
    os.remove(s.Manifest.path_for(root) + ".tmp")


def case_gc_writer_killed_mid_stage(s, root):
    store = s.LogitStoreV2(root, k=K, vocab=V)
    store.append_shard(0, *_shard(0))
    live_files = dict(store.manifest.entry(0).files)
    staged = store._write_shard_files(1, *_shard(1), wave=1)
    for rel in staged.files.values():
        assert os.path.exists(os.path.join(root, rel))
    reopened = s.LogitStoreV2(root)             # gc_on_open sweeps
    for rel in staged.files.values():
        assert not os.path.exists(os.path.join(root, rel))
    for rel in live_files.values():
        assert os.path.exists(os.path.join(root, rel))
    reopened.verify()


def case_gc_on_open(s, root):
    store = s.LogitStoreV2(root, k=K, vocab=V)
    store.append_shard(0, *_shard(0))
    wave0_files = dict(store.manifest.entry(0).files)
    store.append_shard(0, *_shard(1), wave=1)
    assert len(store.manifest.retired) == 1
    for rel in wave0_files.values():
        assert os.path.exists(os.path.join(root, rel))
    again = s.LogitStoreV2(root)
    for rel in wave0_files.values():
        assert not os.path.exists(os.path.join(root, rel))
    assert again.manifest.retired == []
    again.verify()
    assert again.gc() == [] and again.gc() == []


def case_read_entry_pins_superseded_wave(s, root):
    store = s.LogitStoreV2(root, k=K, vocab=V)
    v0, i0 = _shard(7)
    store.append_shard(0, v0, i0)
    pinned = store.manifest.entry(0)
    v1_, i1_ = _shard(8)
    store.append_shard(0, v1_, i1_, wave=1)
    np.testing.assert_array_equal(store.read_entry(pinned, verify=True)[1],
                                  i0)
    np.testing.assert_array_equal(store.read_shard(0)[1], i1_)
    store.gc()
    with pytest.raises(s.ShardCorruptionError):
        store.read_entry(pinned, verify=True)


CASES = {f.__name__[5:]: f for f in (
    case_roundtrip, case_k_vocab_mismatch, case_corrupted_shard,
    case_atomic_supersede, case_stale_wave, case_garbage_tmp_manifest,
    case_gc_writer_killed_mid_stage, case_gc_on_open,
    case_read_entry_pins_superseded_wave)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_store_cases(case, tmp_path):
    """Each case of the reference's store tests, run against each
    package in its own root: both behave as the reference's test asserts
    and leave the same files, byte for byte."""
    roots = {}
    for name, pkg in PKGS.items():
        roots[name] = str(tmp_path / name)
        CASES[case](pkg.store, roots[name])
    jf, pf = _files(roots["jax"]), _files(roots["port"])
    assert sorted(jf) == sorted(pf)
    for rel in jf:
        assert jf[rel] == pf[rel], rel


def test_manifest_version_and_shared_commit(tmp_path):
    """The port refuses a manifest of another version, as the reference
    does; a shared-mode writer merges its commit into a manifest another
    writer advanced, in either package's store."""
    root = str(tmp_path / "s")
    pstore.LogitStoreV2(root, k=K, vocab=V).append_shard(0, *_shard(0))
    m = _manifest(root)
    m["version"] = 1
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(m, f)
    for pkg in PKGS.values():
        with pytest.raises(pkg.store.StoreError, match="version"):
            pkg.store.Manifest.load(root)
    root2 = str(tmp_path / "shared")
    a = pstore.LogitStoreV2(root2, k=K, vocab=V, shared=True)
    b = jstore.LogitStoreV2(root2, k=K, vocab=V, shared=True)
    a.append_shard(0, *_shard(1))
    b.append_shard(1, *_shard(2))
    a.append_shard(2, *_shard(3))
    for pkg in PKGS.values():
        assert pkg.store.LogitStoreV2(root2).verify() == 3
