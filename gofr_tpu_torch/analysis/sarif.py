"""SARIF 2.1.0 output for the unified analyzer front door.

``python -m gofr_tpu_torch.analysis --all --format sarif`` emits one SARIF
run for CI annotation surfaces (GitHub code scanning, editor problem
matchers): one ``result`` per finding, rule metadata inline, stable
finding ids carried as ``partialFingerprints`` so re-runs dedupe.

The port's copy of ``gofr_tpu/analysis/sarif.py``.
"""

from __future__ import annotations

import json

from gofr_tpu_torch.analysis.baseline_io import finding_id
from gofr_tpu_torch.analysis.core import Finding

SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

# one-line rule descriptions, shared with --list-rules
RULE_DESCRIPTIONS = {
    "blocking-call": "blocking primitives in dispatch/decode zones",
    "host-sync": "host-device syncs in the decode hot path",
    "metric-unregistered": "metric name used but never registered",
    "metric-register-site": "metric registered at an arbitrary distance",
    "metric-never-emitted": "catalog metric with zero emission sites",
    "metric-dynamic-name": "computed metric name at a call site",
    "metric-label-cardinality": "unbounded metric label key/value",
    "ctypes-unchecked": "kernel launch status discarded",
    "daemon-loop-no-heartbeat": "unstoppable, unwatchable daemon loop",
    "pubsub-manual-settle": "subscriber handler settles its own message",
    "router-retry-untyped": "router retry path catches non-retriable types",
    "ffi-mismatch": "extern-C vs ctypes signature drift",
    "ffi-unbound": "extern-C symbol with no ctypes binding",
    "ffi-stale": "ctypes binding with no extern-C symbol",
    "ffi-layout": "kernel loader or source directory missing",
    "mesh-axis-unknown": "axis literal not declared by the mesh",
    "collective-unmapped": "literal-axis collective outside shard_map/pmap",
    "use-after-donation": "donated jit buffer read before rebinding",
    "retrace-hazard": "per-request recompiles in the decode hot path",
    "lock-order-static": "cycle in the whole-program lock graph",
    "hold-and-block": "blocking op executed while a lock is held",
    "guarded-by": "write skips the attribute's inferred guard",
    "stale-suppression": "suppression matching no current finding",
    "bad-suppression": "gofrlint suppression without a reason",
    "syntax-error": "file failed to parse",
    "leak-unreleased": "acquired resource with no paired release/transfer",
    "leak-exception-path": "raise/return strands a resource mid-pair",
    "settle-on-raise": "raise after registration without settlement",
    "retire-gate-missing": "commit after blocking call without retire gate",
    "bad-transfer-annotation": "malformed leakcheck ownership annotation",
    "deadline-dropped": "request deadline in scope but not derived into bound",
    "unbounded-wire-call": "serving-reachable wait/wire call with no bound",
    "retry-unbudgeted": "retry/requeue loop with no max-elapsed budget",
    "cancel-unreachable": "cancel-path wait no stop Event can interrupt",
    "zone-drift": "analyzer zone names a file/function that moved",
    "pack-layout-drift": "packed kernel output vs host unpack-column drift",
    "dtype-discipline": "hot-zone dtype hygiene (float64, literal tensors, int64 packs)",
    "carry-field-drift": "DecodeState construction site disagrees with carry spec",
    "spec-rank-mismatch": "shard_map/PartitionSpec vs array rank or pytree drift",
    "kernel-contract-coverage": "kernel-file function without a declared contract",
}


def render_sarif(findings: list[Finding]) -> str:
    rule_ids = sorted({f.rule for f in findings} | set(RULE_DESCRIPTIONS))
    index = {rid: i for i, rid in enumerate(rule_ids)}
    rules = [
        {
            "id": rid,
            "shortDescription": {
                "text": RULE_DESCRIPTIONS.get(rid, rid)
            },
        }
        for rid in rule_ids
    ]
    results = [
        {
            "ruleId": f.rule,
            "ruleIndex": index[f.rule],
            "level": "error",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path,
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {"startLine": max(1, int(f.line))},
                    }
                }
            ],
            "partialFingerprints": {"gofrlintId": finding_id(f)},
        }
        for f in findings
    ]
    doc = {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "gofrlint",
                        "rules": rules,
                    }
                },
                "columnKind": "utf16CodeUnits",
                "results": results,
            }
        ],
    }
    return json.dumps(doc, indent=2)
