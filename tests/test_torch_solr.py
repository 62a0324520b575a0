"""The port's search family (``gofr_tpu_torch/datasource/search``: the
embedded BM25 index and ``SolrClient``) and its ``MiniSolrServer`` beside
the JAX package's:

- the query translation and the cases of ``tests/test_solr.py`` one by one
  with every client against every fake (either package's ``SolrClient`` on
  either package's ``MiniSolrServer``), each result equal to the reference's
  client on the reference's fake;
- ``EmbeddedSearch``: the cases of ``tests/test_datasource_families.py``'s
  ``TestSearch`` on both packages with equal results, and BM25 (k1 1.2, b
  0.75) over a corpus made from a seed: every score equal (``==``) to the
  reference's, unrounded, and the ranked hits equal;
- the port's fake counts the requests it served."""

import types

import numpy as np
import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource import search as rsearch
from gofr_tpu.datasource.search import solr as rsolr
from gofr_tpu.testutil import solr_server as rserver
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource import search as tsearch
from gofr_tpu_torch.datasource.search import solr as tsolr
from gofr_tpu_torch.testutil import solr_server as tserver

PKGS = {
    "ref": types.SimpleNamespace(search=rsearch, solr=rsolr, server=rserver, config=RMapConfig),
    "port": types.SimpleNamespace(search=tsearch, solr=tsolr, server=tserver, config=MapConfig),
}
SIDES = sorted(PKGS)
CROSS = [(c, s) for c in SIDES for s in SIDES]
BOOKS = [
    {"id": "1", "title": "TPU serving systems", "year": 2024, "pages": 300},
    {"id": "2", "title": "Distributed serving at scale", "year": 2023, "pages": 450},
    {"id": "3", "title": "Gardening", "year": 2020, "pages": 120},
]


def outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return ("raised", type(exc).__name__, getattr(exc, "http_status", None), str(exc))


@pytest.mark.parametrize("q", ["*:*", "", "year:2024", "pages:[200 TO 500]", "pages:[* TO 200]",
                               "year:2024 AND pages:[200 TO *]", "serving", "a OR b",
                               'title:"two words"', "score:2.5", "t12 t40"])
def test_query_translation_equals_the_reference(q):
    assert tserver.solr_q_to_query(q) == rserver.solr_q_to_query(q)


# ------------------------------------------------------------- Solr cases
def books(c, name: str = "books"):
    if name in c.list_collections():
        c.delete_collection(name)
    c.create_collection(name)
    c.add(name, [dict(b) for b in BOOKS])


def ids(resp) -> list:
    return [d["id"] for d in resp["response"]["docs"]]


def search_cases(c) -> list:
    books(c)
    return [c.search("books", "year:2024"), ids(c.search("books", "pages:[200 TO 500]")),
            ids(c.search("books", "year:[2023 TO *] AND pages:[400 TO *]")),
            ids(c.search("books", "serving")), ids(c.search("books", "gardening OR tpu")),
            c.search("books", "*:*", rows=2, sort="year desc"),
            ids(c.search("books", "*:*", rows=1, start=1)),
            ids(c.search("books", "*:*", rows=1, sort="year asc")),
            ids(c.search("books", "*:*", rows=1, start=1, sort="year asc"))]


def write_cases(c) -> list:
    books(c)
    c.update("books", [{"id": "1", "title": "TPU serving systems 2e", "year": 2025,
                        "pages": 320}])
    out = [c.search("books", "year:2025")["response"]["docs"]]
    c.delete_by_id("books", ["3", "404"])
    out.append(c.search("books", "*:*")["response"]["numFound"])
    c.delete_by_query("books", "pages:[400 TO *]")
    out.append(ids(c.search("books", "*:*")))
    c.add("books", [{"id": "9", "title": "later"}], commit=False)
    out.append(ids(c.search("books", "later")))
    return out


def error_cases(c) -> list:
    books(c)
    return [outcome(c.search, "nope", "*:*"), outcome(c.add, "books", [{"title": "anonymous"}]),
            outcome(c.create_collection, "books"), outcome(c.delete_collection, "ghost"),
            outcome(c._get, "/solr/admin/collections", {"action": "SPLIT"}),
            outcome(c._request, "POST", "/solr/books/update", None, {"commit": True}),
            sorted(c.list_collections()), c.health_check()["details"]["collections"]]


CASES = [search_cases, write_cases, error_cases]


@pytest.fixture(scope="module")
def servers():
    out = {side: PKGS[side].server.MiniSolrServer() for side in SIDES}
    yield out
    for s in out.values():
        s.close()


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
@pytest.mark.parametrize("client_side,server_side", CROSS)
def test_solr_cases_crossed_both_ways(servers, client_side, server_side, case):
    ref = rserver.MiniSolrServer()
    try:
        want = case(rsolr.SolrClient(url=ref.url))
    finally:
        ref.close()
    got = case(PKGS[client_side].solr.SolrClient(url=servers[server_side].url))
    assert got == want


@pytest.mark.parametrize("side", SIDES)
def test_health_config_and_a_dark_endpoint(side, servers):
    p = PKGS[side]
    built = p.solr.SolrClient.from_config(p.config({"SOLR_URL": servers[side].url + "/"},
                                                   use_env=False))
    built.connect()
    health = built.health_check()
    assert (health["status"], health["details"]["backend"], built.url) == (
        "UP", "solr", servers[side].url)
    dark = p.solr.SolrClient(url="http://127.0.0.1:1", timeout=0.3)
    down = dark.health_check()
    assert down["status"] == "DOWN" and down["details"]["url"] == "http://127.0.0.1:1"
    err = outcome(dark.search, "books")
    assert err[:3] == ("raised", "SolrError", 500)


def test_the_port_fake_counts_what_it_served():
    server = tserver.MiniSolrServer()
    try:
        c = tsolr.SolrClient(url=server.url)
        c.connect()
        search_cases(c)
        c.health_check()
    finally:
        server.close()
    assert server.commands == {"admin:LIST": 3, "admin:CREATE": 1, "update": 1, "select": 9}


# ------------------------------------------------------------- embedded
def es_cases(es) -> list:
    es.connect()
    es.create_index("articles")
    es.index_document("articles", "1", {"title": "TPU serving at scale", "views": 100})
    es.index_document("articles", "2", {"title": "Serving LLMs on TPU pods", "views": 250})
    es.index_document("articles", "3", {"title": "A gardening guide", "views": 5})
    out = [es.search("articles", {"query": {"match": {"title": "tpu serving"}}}),
           es.search("articles", {"query": {"term": {"views": 100}}}),
           es.search("articles", {"query": {"term": {"views": {"value": 250}}}}),
           es.search("articles", {"query": {"range": {"views": {"gte": 100, "lt": 250}}}}),
           es.search("articles", {"query": {"bool": {
               "must": [{"match": {"title": "tpu"}}], "must_not": [{"term": {"views": 100}}]}}}),
           es.search("articles", {"query": {"bool": {"should": [
               {"match": {"title": "guide"}}, {"match": {"_all": "pods"}}]}}}),
           es.search("articles", {"match_all": {}}, size=2),
           outcome(es.search, "articles", {"query": {"fuzzy": {"title": "x"}}})]
    es.update_document("articles", "1", {"views": 101})
    out += [es.get_document("articles", "1"),
            es.search("articles", {"query": {"term": {"views": 101}}})["hits"]["total"]]
    es.delete_document("articles", "1")
    out += [es.get_document("articles", "1"),
            es.search("articles", {"query": {"match": {"title": "scale"}}})["hits"]["total"],
            es.bulk([{"index": {"_index": "articles", "_id": "9", "doc": {"title": "bulk doc"}}},
                     {"delete": {"_index": "articles", "_id": "no-such"}},
                     {"upsert": {}}]),
            outcome(es.create_index, "articles"), outcome(es.delete_index, "nope"),
            outcome(es.update_document, "articles", "404", {"a": 1}),
            outcome(es.search, "nope", {}), es.health_check()]
    es.delete_index("articles")
    out += [es.indices(), es.health_check()]
    es.close()
    return out


def test_embedded_search_cases_equal_the_reference():
    got = {side: es_cases(PKGS[side].search.EmbeddedSearch()) for side in SIDES}
    assert got["port"] == got["ref"]
    scores = [h["_score"] for h in got["port"][0]["hits"]["hits"]]
    assert scores == sorted(scores, reverse=True) and all(s > 0 for s in scores)


def corpus(seed: int, n_docs: int = 60, vocab: int = 40) -> list[dict]:
    """Documents of ``t<id>`` words drawn from a Zipf-like law, as the
    generation jobs' index holds them."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, vocab + 1)
    weights /= weights.sum()
    out = []
    for i in range(n_docs):
        toks = rng.choice(vocab, size=int(rng.integers(1, 48)), p=weights)
        out.append({"id": f"job-{i}", "text": " ".join(f"t{t}" for t in toks),
                    "n": int(rng.integers(0, 100))})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bm25_scores_are_equal_bit_for_bit(seed):
    docs = corpus(seed)
    rng = np.random.default_rng(seed + 100)
    queries = [[f"t{int(t)}" for t in rng.integers(0, 45, size=int(rng.integers(1, 4)))]
               for _ in range(12)]
    got = {}
    for side in SIDES:
        es = PKGS[side].search.EmbeddedSearch()
        for d in docs:
            es.index_document("jobs", d["id"], d)
        es.index_document("jobs", "job-0", {**docs[0], "text": docs[0]["text"] + " t1"})
        es.delete_document("jobs", "job-1")
        idx = es._indices["jobs"]
        got[side] = ([idx.bm25(terms) for terms in queries],
                     [es.search("jobs", {"query": {"match": {"_all": " ".join(terms)}}}, size=20)
                      for terms in queries])
    assert got["port"] == got["ref"]
    assert any(got["port"][0])
