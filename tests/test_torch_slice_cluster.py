"""The cluster core end to end against the JAX package, on the CPU.

* The placement hashes (``fnv64a``, ``jump_hash``, ``shard_to_partition``,
  ``key_to_partition``) over 10,000 seeded keys, shards and node counts,
  and ``ClusterSnapshot`` owners for shards 0-255 at 1-5 nodes and 1-3
  replicas, equal to the JAX package's.
* Translate replication: ``create_entries`` / ``apply_entries`` of both
  stores, entry for entry and next id for next id.
* A 3-node ``LocalCluster`` of each package loaded through its
  coordinator from the same seeded numpy data (the SSB shape of path 16a
  and the BSI shape of 16b, cut to a few thousand columns over three
  shards): which node holds which shard, every node's key->id maps, and
  every 16a / 16b query from every node equal across the packages and to
  numpy; the node-to-node routes answer alike, the gossip, membership
  and catch-up routes among them (those planes off; a shard snapshot
  compared by its LSN and arrays).
* One mixed cluster on loopback: two port nodes and one JAX node over
  ``StaticDisCo``, which holds the wire format (query legs, imports,
  translation, broadcasts): a Count, a TopN, a GroupBy, a keyed ``Set``
  and a ``Percentile`` from each node equal to the single-node oracle.
* 8 concurrent clients against a port cluster, each answer equal to the
  serial one.
* The cluster config keys; ``ClusterNode()`` and ``LocalCluster(1)``
  raise without a card when no device is named.

Tolerance 0: every answer is a count, a bitmap or a host-decoded value.
"""

import dataclasses
import random
import socket
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import pilosa_tpu.cluster as JC
import pilosa_tpu.hashing as JH
from pilosa_tpu.cluster.node import ClusterNode as JaxNode
from pilosa_tpu.config import Config as JaxConfig
from pilosa_tpu.core import translate as JT
from pilosa_tpu.server.http import serve as jax_serve
import pilosa_tpu_torch.cluster as TC
import pilosa_tpu_torch.hashing as TH
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.cluster.node import ClusterNode as TorchNode
from pilosa_tpu_torch.config import Config as TorchConfig
from pilosa_tpu_torch.core import translate as TT
from pilosa_tpu_torch.server.http import serve as torch_serve
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SW = SHARD_WIDTH
TIMEOUT = 120


def plain(r):
    if dataclasses.is_dataclass(r):
        return dataclasses.asdict(r)
    if isinstance(r, list):
        return [plain(x) for x in r]
    return r


# -- placement ---------------------------------------------------------------


def test_hashes_equal_the_jax_packages():
    rng = random.Random(16)
    for _ in range(10_000):
        n = rng.randrange(1, 40)
        key = "".join(chr(rng.randrange(32, 0x2FF)) for _ in range(n))
        index = rng.choice(["i", "ssb", "idx-" + key[:3]])
        shard = rng.randrange(0, 1 << 40)
        word = rng.getrandbits(64)
        nodes = rng.randrange(1, 64)
        parts = rng.choice([1, 7, 256, 1024])
        assert TH.fnv64a(key.encode()) == JH.fnv64a(key.encode())
        assert TH.jump_hash(word, nodes) == JH.jump_hash(word, nodes)
        assert TH.shard_to_partition(index, shard, parts) == \
            JH.shard_to_partition(index, shard, parts)
        assert TH.key_to_partition(index, key, parts) == \
            JH.key_to_partition(index, key, parts)
    assert TH.jump_hash(5, 0) == JH.jump_hash(5, 0) == -1


def test_shard_owners_equal_the_jax_packages():
    for n in range(1, 6):
        for replicas in range(1, 4):
            tn = [TC.Node(id=f"node{i}", uri="") for i in range(n)]
            jn = [JC.Node(id=f"node{i}", uri="") for i in range(n)]
            ts = TC.ClusterSnapshot(tn, replica_n=replicas)
            js = JC.ClusterSnapshot(jn, replica_n=replicas)
            assert ts.replica_n == js.replica_n
            for index in ("ssb", "b"):
                for shard in range(256):
                    assert [x.id for x in ts.shard_nodes(index, shard)] == \
                        [x.id for x in js.shard_nodes(index, shard)]
            assert ts.primary_field_translation_node().id == \
                js.primary_field_translation_node().id
            live = [f"node{i}" for i in range(n)]
            for down in range(n + 1):
                assert ts.cluster_state(live[down:]) == \
                    js.cluster_state(live[down:])


# -- translate replication ---------------------------------------------------


@pytest.mark.parametrize("kind", ["field", "partitioned"])
def test_create_and_apply_entries_equal_the_jax_packages(kind, tmp_path):
    def store(mod, tag):
        path = str(tmp_path / f"{tag}.jsonl")
        if kind == "field":
            return mod.TranslateStore(path, start=1)
        return mod.PartitionedTranslateStore("ssb", path)

    rng = random.Random(7)
    batches = [[f"k{rng.randrange(400)}" for _ in range(rng.randrange(1, 60))]
               for _ in range(20)]
    tp, jp = store(TT, "tp"), store(JT, "jp")
    tr, jr = store(TT, "tr"), store(JT, "jr")
    for keys in batches:
        tout, tnew = tp.create_entries(keys)
        jout, jnew = jp.create_entries(keys)
        assert tout == jout and [tuple(e) for e in tnew] == \
            [tuple(e) for e in jnew]
        # the replicas apply the primary's entries, twice (idempotent)
        for _ in range(2):
            tr.apply_entries(tnew)
            jr.apply_entries(jnew)
    assert tr.key_to_id == jr.key_to_id == tp.key_to_id
    assert tr.id_to_key == jr.id_to_key
    # a promoted replica allocates the ids the JAX package's would
    tout, tnew = tr.create_entries(["fresh-a", "fresh-b", "k1"])
    jout, jnew = jr.create_entries(["fresh-a", "fresh-b", "k1"])
    assert tout == jout and tnew == jnew
    assert not set(tout.values()) - {tout["k1"]} & set(tp.id_to_key)
    # the journals replay to the same maps
    again = store(TT, "tr")
    assert again.key_to_id == tr.key_to_id


def test_create_keys_is_create_entries():
    t = TT.PartitionedTranslateStore("i")
    j = JT.PartitionedTranslateStore("i")
    keys = [f"r{i}" for i in range(300)]
    assert t.create_keys(keys) == j.create_keys(keys)


# -- a 3-node cluster of each package ----------------------------------------

YEARS, BRANDS, AMOUNT_DEPTH = 7, 24, 20
N_COLS = 3_000


def _data(seed: int = 16):
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.choice(3 * SW, N_COLS, replace=False))
    year_of = rng.integers(0, YEARS, N_COLS)
    brand_of = rng.integers(0, BRANDS, N_COLS)
    amount = rng.integers(0, 1 << AMOUNT_DEPTH, N_COLS)
    names = np.array([f"MFGR#{1000 + b}" for b in range(BRANDS)])
    return cols, year_of, brand_of, amount, names


def _load(node, data, oracle=False):
    """Load ``data`` through ``node``'s coordinator. A cluster creates the
    brand keys in order of first appearance, shard by shard; a
    single-node ``oracle`` gets its keys created in that order first, so
    equal counts rank by equal ids."""
    cols, year_of, brand_of, amount, names = data
    node.create_index("ssb")
    node.create_field("ssb", "year", {"type": "mutex"})
    node.create_field("ssb", "brand", {"type": "mutex", "keys": True})
    if oracle:
        node.holder.index("ssb").field("brand").translate.create_keys(
            list(dict.fromkeys(names[brand_of].tolist())))
    node.create_index("b")
    node.create_field("b", "amount", {"type": "int"})
    node.create_index("kk", {"keys": True})
    node.create_field("kk", "tag", {"keys": True})
    for s in range(3):  # one shard's columns a call, as one batch would
        sel = (cols // SW) == s
        node.import_bits("ssb", "year", rows=year_of[sel].tolist(),
                         cols=cols[sel].tolist())
        node.import_bits("ssb", "brand", cols=cols[sel].tolist(),
                         row_keys=names[brand_of[sel]].tolist())
        node.import_values("b", "amount", cols=cols[sel].tolist(),
                           values=amount[sel].tolist())
    node.import_bits("kk", "tag",
                     row_keys=[f"t{i % 9}" for i in range(300)],
                     col_keys=[f"rec{i}" for i in range(300)])


QUERIES_16A = [
    "Count(Row(year=3))",
    'Count(Intersect(Row(year=3), Row(brand="MFGR#1007")))',
    "TopN(brand, n=10)",
    "GroupBy(Rows(year), Rows(brand), limit=100)",
    "GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)",
]
HALF = 1 << (AMOUNT_DEPTH - 1)
QUERIES_16B = [
    f"Count(Row(amount > {HALF}))",
    f"Sum(Row(amount > {HALF}), field=amount)",
    "Min(field=amount)",
    "Max(field=amount)",
    "Percentile(field=amount, nth=50)",
    "Percentile(field=amount, nth=99)",
]


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def clusters(data):
    jc = JC.LocalCluster(3)
    tc = TC.LocalCluster(3, device="cpu")
    try:
        _load(jc.coordinator, data)
        _load(tc.coordinator, data)
        yield jc, tc
    finally:
        tc.close()
        jc.close()


def test_shards_and_key_maps_equal_across_packages(clusters):
    jc, tc = clusters
    held = []
    for jn, tn in zip(jc.nodes, tc.nodes):
        for index in ("ssb", "b", "kk"):
            assert tn.holder.index(index).shards() == \
                jn.holder.index(index).shards(), (tn.node.id, index)
        held.append(bool(tn.holder.index("ssb").shards()))
        for index, field in (("ssb", "brand"), ("kk", "tag")):
            tf = tn.holder.index(index).field(field).translate.key_to_id
            jf = jn.holder.index(index).field(field).translate.key_to_id
            assert tf == jf, (tn.node.id, index, field)
        assert tn.holder.index("kk").translate.key_to_id == \
            jn.holder.index("kk").translate.key_to_id
        assert sorted(tn.all_shards("ssb")) == [0, 1, 2]
    assert sum(held) >= 2  # the data really is spread


def _oracle(data, q):
    cols, year_of, brand_of, amount, _ = data
    if q == "Count(Row(year=3))":
        return int((year_of == 3).sum())
    if q.startswith("Count(Intersect"):
        return int(((year_of == 3) & (brand_of == 7)).sum())
    if q == f"Count(Row(amount > {HALF}))":
        return int((amount > HALF).sum())
    if q.startswith("Sum("):
        big = amount[amount > HALF]
        return (int(big.sum()), int(big.size))
    if q == "Min(field=amount)":
        lo = int(amount.min())
        return (lo, int((amount == lo).sum()))
    if q == "Max(field=amount)":
        hi = int(amount.max())
        return (hi, int((amount == hi).sum()))
    return None


@pytest.mark.parametrize("q", QUERIES_16A + QUERIES_16B)
def test_every_query_from_every_node_equal_across_packages(clusters, data,
                                                           q):
    jc, tc = clusters
    index = "ssb" if q in QUERIES_16A else "b"
    want = plain(jc.coordinator.query(index, q))
    for tn in tc.nodes:
        assert plain(tn.query(index, q)) == want, (tn.node.id, q)
    oracle = _oracle(data, q)
    if oracle is not None:
        got = tc.coordinator.query("ssb" if q in QUERIES_16A else "b", q)[0]
        val = (got.val, got.count) if hasattr(got, "val") else got
        assert val == oracle, q


def test_groupby_and_topn_equal_numpy(clusters, data):
    _, tc = clusters
    cols, year_of, brand_of, _, names = data
    groups, top = tc[2].query(
        "ssb", "GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)")
    table = np.bincount(year_of * BRANDS + brand_of,
                        minlength=YEARS * BRANDS).reshape(YEARS, BRANDS)
    # the brand keys live on the field primary; any node finds them
    fb = tc[2].executor.translator.field_keys("ssb", "brand",
                                              names.tolist(), create=False)
    bid = {b: fb[names[b]] for b in range(BRANDS)}
    want = sorted((y, bid[b], int(table[y, b])) for y in range(YEARS)
                  for b in range(BRANDS) if table[y, b])[:100]
    got = [(g.group[0].row_id, fb[g.group[1].row_key], g.count)
           for g in groups]
    assert got == want
    counts = np.bincount(brand_of, minlength=BRANDS)
    ranked = sorted((-int(c), bid[b], names[b])
                    for b, c in enumerate(counts) if c)[:10]
    assert [(p.key, p.count) for p in top.pairs] == \
        [(k, -c) for c, _, k in ranked]


def test_percentile_equals_the_single_node_port(clusters, data):
    _, tc = clusters
    cols, _, _, amount, _ = data
    single = TorchAPI(device="cpu")
    single.create_index("b")
    single.create_field("b", "amount", {"type": "int"})
    single.import_values("b", "amount", cols=cols.tolist(),
                         values=amount.tolist())
    for nth in (50, 99):
        q = f"Percentile(field=amount, nth={nth})"
        assert plain(tc.coordinator.query("b", q)) == \
            plain(single.query("b", q))


def test_routed_writes_read_back_everywhere(clusters):
    jc, tc = clusters
    writes = [(s * SW + 4242 + s, 5) for s in range(3)]
    for c in (jc, tc):
        for col, row in writes:
            c[1].query("ssb", f"Set({col}, year={row})")
        c[1].import_bits("ssb", "year", rows=[6] * 3,
                         cols=[s * SW + 7 for s in range(3)])
    for jn, tn in zip(jc.nodes, tc.nodes):
        for q in ("Count(Row(year=5))", "Row(year=6)", "TopN(year)"):
            assert plain(tn.query("ssb", q)) == plain(jn.query("ssb", q))


def _get(base, path, method="GET", body=None):
    import json
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npz(blob):
    import base64
    import io

    if not blob:
        return {}
    with np.load(io.BytesIO(base64.b64decode(blob))) as z:
        return {k: z[k] for k in z.files}


def _no_uris(doc):
    if isinstance(doc, dict):
        return {k: ("" if k == "uri" else _no_uris(v)) for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return [_no_uris(v) for v in doc]
    return doc


def test_node_routes_equal_the_jax_packages(clusters):
    jc, tc = clusters
    routes = [("GET", "/status", None), ("GET", "/internal/nodes", None),
              ("GET", "/internal/index/ssb/shards", None),
              ("GET", "/ui/shard-distribution", None),
              ("GET", "/internal/partition/nodes?partition=0", None),
              ("GET", "/internal/partition/nodes?partition=77", None),
              ("POST", "/internal/index/ssb/query",
               {"query": "Count(Row(year=3))", "shards": [2, 3]}),
              ("POST", "/internal/translate/field/ssb/brand/keys/find",
               {"keys": ["MFGR#1003", "nope"]}),
              ("POST", "/internal/query-batch",
               {"queries": [{"index": "ssb", "query": "Count(Row(year=3))",
                             "shards": [2, 3]},
                            {"index": "nope", "query": "Count(Row(f=1))",
                             "shards": [0]}]}),
              # gossip, membership and catch-up with those planes off
              ("GET", "/internal/gossip/state", None),
              ("POST", "/internal/gossip/exchange", {"gossip": {}}),
              ("GET", "/internal/membership", None),
              ("POST", "/internal/membership/ping", {"from": "nodeX"}),
              ("GET", "/internal/recovery/wal?index=ssb&since=3", None)]
    for k in range(3):
        for method, path, body in routes:
            got = _get(tc[k].node.uri, path, method, body)
            want = _get(jc[k].node.uri, path, method, body)
            assert _no_uris(got) == _no_uris(want), (k, path)
        # a shard snapshot: the same LSN and arrays (the npz bytes carry
        # their zip entries' times)
        for shard in (0, 2, 5):
            path = f"/internal/recovery/snapshot?index=ssb&shard={shard}"
            (st, got), (sj, want) = (_get(c[k].node.uri, path)
                                     for c in (tc, jc))
            assert st == sj == 200
            assert {**got, "npz": ""} == {**want, "npz": ""}, (k, shard)
            assert _npz(got["npz"]).keys() == _npz(want["npz"]).keys()
            for key, arr in _npz(got["npz"]).items():
                np.testing.assert_array_equal(arr, _npz(want["npz"])[key])
    # the coalesced batch is served on a node of both packages
    assert _get(tc[1].node.uri, "/internal/query-batch", "POST",
                {"queries": []}) == (200, {"results": []})


# -- a mixed cluster: two port nodes and one JAX node ------------------------


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_mixed_cluster_holds_the_wire_format(data):
    ports = _free_ports(3)
    uris = [f"http://127.0.0.1:{p}" for p in ports]
    nodes, servers = [], []
    try:
        for i, uri in enumerate(uris):
            is_jax = i == 2
            C = JC if is_jax else TC
            disco = C.StaticDisCo([C.Node(id=f"node{k}", uri=u)
                                   for k, u in enumerate(uris)])
            if is_jax:
                node = JaxNode(f"node{i}", uri, disco)
                srv, _ = jax_serve(node, port=ports[i], background=True)
            else:
                node = TorchNode(f"node{i}", uri, disco, device="cpu")
                srv, _ = torch_serve(node, port=ports[i], background=True)
            nodes.append(node)
            servers.append(srv)
        cols, year_of, brand_of, amount, names = data
        oracle = TorchAPI(device="cpu")
        _load(nodes[0], data)
        _load(oracle, data, oracle=True)
        for i, node in enumerate(nodes):
            node.query("kk", f'Set("mixed{i}", tag="t{i}")')
            oracle.query("kk", f'Set("mixed{i}", tag="t{i}")')
        queries = [("ssb", "Count(Row(year=3))"),
                   ("ssb", "TopN(brand, n=10)"),
                   ("ssb", "GroupBy(Rows(year), Rows(brand), limit=100)"),
                   ("b", "Percentile(field=amount, nth=50)"),
                   ("kk", 'Count(Row(tag="t1"))'),
                   ("kk", 'Row(tag="t2")')]
        for index, q in queries:
            want = plain(oracle.query(index, q))
            for node in nodes:
                got = plain(node.query(index, q))
                if index == "kk" and q.startswith("Row"):
                    got[0]["keys"] = sorted(got[0]["keys"])
                    want[0]["keys"] = sorted(want[0]["keys"])
                assert got == want, (node.node.id, q)
        # the JAX node holds shards, and so do the port's nodes
        assert nodes[2].holder.index("ssb").shards()
        assert nodes[0].holder.index("ssb").shards() | \
            nodes[1].holder.index("ssb").shards()
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


# -- concurrency -------------------------------------------------------------


def test_concurrent_clients_equal_serial(clusters):
    _, tc = clusters
    rng = random.Random(8)
    cheap = [("ssb", q) for q in QUERIES_16A if "GroupBy" not in q] + \
        [("b", q) for q in QUERIES_16B if "Percentile" not in q]
    work = [(rng.randrange(3),) + rng.choice(cheap) for _ in range(30)]
    work += [(1, "ssb", QUERIES_16A[3]), (2, "b", QUERIES_16B[4])]
    rng.shuffle(work)
    serial = [plain(tc[n].query(i, q)) for n, i, q in work]

    def client(k):
        return [plain(tc[n].query(i, q)) for n, i, q in work[k::8]]

    with ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(client, k) for k in range(8)]
        got = [f.result(timeout=TIMEOUT) for f in futs]
    for k in range(8):
        assert got[k] == serial[k::8]


# -- config and device -------------------------------------------------------


def test_cluster_config_keys_wait_for_a_server_that_reads_them(tmp_path):
    """Nothing reads ``node-id``, ``peers`` or ``replicas`` yet (ROADMAP
    C.16), so the port's ``Config`` has no field for them; a file and an
    environment that set them load every other key as the JAX package's
    do."""
    keys = {"node_id", "peers", "replicas"}
    assert keys <= {f.name for f in dataclasses.fields(JaxConfig)}
    assert not keys & {f.name for f in dataclasses.fields(TorchConfig)}
    toml = tmp_path / "c.toml"
    toml.write_text('node-id = "node3"\npeers = ["http://a:1"]\n'
                    'replicas = 2\nbind = "h:1"\n')
    env = {"PILOSA_TPU_REPLICAS": "3", "PILOSA_TPU_WAL_SYNC": "always"}
    t = TorchConfig.from_sources(toml_path=str(toml), env=env)
    j = JaxConfig.from_sources(toml_path=str(toml), env=env)
    assert (t.bind, t.wal_sync) == (j.bind, j.wal_sync) == ("h:1", "always")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the error without a card")
def test_no_device_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.ClusterNode("n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.LocalCluster(1)
