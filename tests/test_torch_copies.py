"""The process entry's modules are copies: each port file equals the JAX
package's after the package name is replaced and the JAX package's
provenance tags (issue, PR and review numbers in comments and docstrings,
SCRUB) are dropped, except the functions named in CHANGED, which the
port changed on purpose (the driver wiring, the parser, the device
profiler and the routing calibration of main.py, compilestats' pytree walk without JAX, the code
fingerprint over the kernels' sources, where the snapshot writer and
loader move the resident mask between the host and the device, the
fleet replica's driver and brownout flags and its warm ready probe, the threaded
front door's listen backlog, the webhook's generational collector sweeper, and the
numpy evaluation the np side calls).  A reader of the port reads
only those."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "gatekeeper_tpu"
PORT_PKG = ROOT / "gatekeeper_tpu_torch"

COPIED = (
    "__main__.py", "logging.py", "deadline.py", "operations.py",
    "faults/__init__.py", "faults/plane.py",
    "syncutil/__init__.py", "util/seal.py",
    "apis/config.py", "apis/status.py",
    "process/__init__.py", "process/excluder.py",
    "kube/__init__.py", "kube/inmem.py", "kube/clients.py",
    "kube/http_client.py",
    "metrics/__init__.py", "metrics/catalog.py", "metrics/exporter.py",
    "metrics/views.py",
    "obs/__init__.py", "obs/trace.py", "obs/slo.py", "obs/decisionlog.py",
    "obs/routeledger.py", "obs/debug.py", "obs/flightrec.py",
    "obs/costs.py", "obs/brownout.py", "obs/profiler.py",
    "obs/reactorobs.py", "obs/compilestats.py",
    "watch/__init__.py", "watch/manager.py", "watch/set.py",
    "readiness/__init__.py", "readiness/tracker.py",
    "controllers/__init__.py", "controllers/base.py",
    "controllers/config.py", "controllers/constraint.py",
    "controllers/constrainttemplate.py", "controllers/registry.py",
    "controllers/status.py", "controllers/sync.py",
    "upgrade/__init__.py", "certs/__init__.py", "certs/rotator.py",
    "webhook/__init__.py", "webhook/policy.py",
    "webhook/namespacelabel.py", "webhook/server.py",
    "audit/__init__.py", "audit/manager.py",
    "snapshot/__init__.py", "snapshot/format.py", "snapshot/writer.py",
    "snapshot/loader.py",
    "main.py",
    "fleet/__init__.py", "fleet/wireproto.py", "fleet/evloop.py",
    "fleet/wirelistener.py", "fleet/frontdoor.py", "fleet/evdoor.py",
    "fleet/replica.py", "fleet/supervisor.py",
    "obs/fleetobs.py", "util/overloadcheck.py",
    "ops/breaker.py", "ops/npside.py",
    "kube/apiserver.py",
    "analysis/__init__.py", "analysis/core.py", "analysis/evloopsafety.py",
    "analysis/failpolicy.py", "analysis/hygiene.py", "analysis/locks.py",
    "analysis/queuebound.py", "analysis/registrycheck.py",
    "analysis/tracesafety.py",
)

# file -> the top-level names (functions, classes' methods as
# "Class.method", assigned constants) the port changed or added
CHANGED = {
    "main.py": {
        # the parser: prog, --driver interp|torch (default torch),
        # --torch-device, and --jax-profile-port's help (torch.profiler)
        "build_parser",
        # TorchDriver in place of TpuDriver
        "App.__init__",
        # the kernels loaded (wait_ready) before anything serves; the
        # device profiler (obs/devprof.py) in place of jax.profiler's
        # server, started and stopped where the JAX App does
        "App.start", "App.stop",
        # waits for /readyz before it calibrates (TorchDriver measures the
        # render of the cache's objects), and skips the calibration, as the
        # JAX package's does, when DEVICE_MIN_CELLS is 0
        "App._start_routing_calibration",
    },
    "fleet/frontdoor.py": {
        # the threaded door listens with a backlog of 1024, as
        # EventFrontDoor and the wire listener do: socketserver's 5
        # overflowed under the overload drill's burst of new connections,
        # and a dropped SYN's 1 s retransmission made a 429 take ~1.03 s
        "FrontDoor.start",
    },
    "ops/npside.py": {
        # evaluates through ops/npeval.py, whose match and programs are
        # numpy's alone (no xp argument, numpy arrays out)
        "_Group.eval",
    },
    "obs/compilestats.py": {
        # sums nbytes over tensors and numpy arrays without jax's pytrees
        "tree_nbytes",
    },
    "util/seal.py": {
        # hashes the kernels' sources (.cu, .cuh) too: a snapshot's delta
        # basis made by other kernels is never restored
        "code_fingerprint",
    },
    "controllers/config.py": {
        # drops only the data the new config no longer keeps, where the
        # JAX package wipes it all: a warm-resumed inventory survives the
        # Config's first reconcile
        "ConfigController.reconcile",
    },
    "snapshot/writer.py": {
        # the resident mask (a tensor on the card, or a mesh sweep's
        # ShardedMask) brought to the host with .cpu(), not np.asarray
        "SnapshotWriter._resolve_mask",
    },
    "snapshot/loader.py": {
        # the restored mask placed on the driver's device, or in slabs on
        # the mesh's shards, without jax.device_put
        "SnapshotLoader._restore_delta",
    },
    "webhook/server.py": {
        # the collector's sweeper is generational (gc_sweep): each sweep
        # collects the young generations, and the old one only once it
        # has grown by a quarter since its last collection.  The JAX
        # package's full collection every 5 s scanned all the serving
        # state a replica keeps (its request memo's entries), 62-567 ms
        # with the GIL held on an H100's host: each a reactor stall over
        # the edge objective's 50 ms, which held young replicas at
        # brownout 3
        "gc_sweep", "WebhookServer.start",
    },
    "fleet/replica.py": {
        # --driver interp|torch (default torch) and --torch-device
        # (default cuda), as main.build_parser has them: a replica runs
        # the card's kernels unless told otherwise, and without a card
        # it fails to start (TorchDriver raises; no quiet fallback);
        # and --brownout-disable, as the App has it
        "_child_parser",
        # the three flags passed on to the App; GK_AOT_READ_MOSTLY dropped,
        # since the kernel cache has no entries a replica could prune
        # (a library's name hashes its sources, a broken seal is rebuilt
        # under a temporary name and renamed into place); and the first
        # evaluation paid through the client before the ready probe
        "main",
        # the ready probe's request built by _probe_request, which main's
        # first evaluation reviews too: the admission objective counts the
        # probe, and a probe that paid the first evaluation (slower than
        # its 100 ms) fired its alerts once a young replica had served ten
        # requests, stepping its brownout ladder up (a respawn in
        # chip_smoke's phase 12 at level 1)
        "_probe_request", "_probe_ready",
    },
}

# the operator tools the port copied: port tool -> (its JAX twin, the
# names the port changed; "__doc__" for the module docstring)
TOOLS = {
    "tools/replay_decisions_torch.py": ("tools/replay_decisions.py", {
        # the tool's own name in its usage, the engine and its device
        "__doc__",
        # the report counts the live router's tier of each replayed batch
        "replay_records",
        # TorchDriver on --torch-device (default cuda) in place of
        # TpuDriver, and an engine that fails to build exits 2
        "build_handler_from_snapshot", "_selftest_handler", "run_selftest",
        "_selftest_body", "main",
    }),
    # the operator's drills.  Every main takes --torch-device (default
    # cuda) and argv; a card asked for and missing raises (select_device),
    # never a quiet run on the CPU
    "tools/check_render_parity_torch.py": ("tools/check_render_parity.py", {
        "__doc__",
        # the corpus is the port's copy (util/rendercorpus.py): the
        # tests' module imports the JAX package
        "_corpus_modules",
        "main",
    }),
    "tools/check_observability_torch.py": ("tools/check_observability.py", {
        "__doc__",
        # the port's files: no ops/xlacache.py, ops/asynccompile.py or
        # ops/aotcache.py (device.py's sealed build cache takes their
        # place); obs/devprof.py added
        "HOT_PATH_MODULES",
        # the caches only the port records (the kernels' sealed build
        # cache) documented in README.md's port section, not in the JAX
        # package's docs
        "_CACHE_CALL", "PORT_SECTION", "check_port_series_documented",
        "run_checks",
        "main",
    }),
    "tools/check_mesh_parity_torch.py": ("tools/check_mesh_parity.py", {
        "__doc__",
        # TorchDriver on DEVICE (main's --torch-device)
        "DEVICE", "_driver",
        # GK_VIRTUAL_DEVICES=4 slots of the one device, where the JAX tool
        # asks jax.devices() and re-execs onto 8 virtual CPU devices
        "_reexec_on_virtual_mesh", "main",
    }),
    "tools/check_join_parity_torch.py": ("tools/check_join_parity.py", {
        "__doc__",
        # TorchDriver on DEVICE, and no TpuDriver.DELTA_MASK_WAIT_S: the
        # JAX tool waits for a resident mask its prefetch thread may still
        # be computing; TorchDriver's sweep commits its mask resolved, so
        # a delta sweep never waits on one
        "DEVICE", "_driver",
        "_reexec_on_virtual_mesh", "main",
    }),
    # the fleet drills: the client on DEVICE, the replicas the port's
    # with --driver torch --torch-device DEVICE (no JAX_PLATFORMS env),
    # their kernel cache CACHE_DIR (--xla-cache-dir) when given
    "tools/check_fleet_parity_torch.py": ("tools/check_fleet_parity.py", {
        "__doc__", "DEVICE", "CACHE_DIR", "run_checks", "main",
    }),
    "tools/check_self_heal_torch.py": ("tools/check_self_heal.py", {
        "__doc__", "DEVICE", "CACHE_DIR", "run_checks", "main",
    }),
    # the overload drill's run_checks also freezes what its process held
    # before the drill while it drives the doors: a full collection over
    # a test worker's heap inside a burst was charged to the door
    "tools/check_overload_torch.py": ("tools/check_overload.py", {
        "__doc__", "DEVICE", "CACHE_DIR", "run_checks", "main",
    }),
    # the chart generator over the port's manifest
    # (deploy/gatekeeper-torch.yaml -> charts/gatekeeper-tpu-torch/)
    "tools/helmify_torch.py": ("tools/helmify.py", {
        "__doc__", "MANIFEST", "CHART",
        # the chart's name and description
        "CHART_YAML",
        # the manifest's lines the knobs anchor on: the image, the GPU
        # nodeSelector, nvidia.com/gpu, --driver=torch; the values
        # gpuResource / gpuCount in place of tpuResource / tpuCount
        "REPLACEMENTS", "VALUES_DEFAULTS", "README_PARAMS",
        # the README's title, install lines and seal-key note
        "render_readme",
    }),
    # the render corpus the render drill reads, a copy of the tests'
    "gatekeeper_tpu_torch/util/rendercorpus.py": ("tests/render_corpus.py", {
        "__doc__",
    }),
}

# file -> ((JAX text, port text), ...): changes of whole statements.  The
# port's __main__ runs only as a script, so that importing it (as
# tests/test_torch_imports.py imports every module) starts no process;
# the np side imports its match and programs from ops/npeval.py, not from
# the torch modules of the same names
REPLACED = {
    "__main__.py": (
        ("\nmain()\n", '\nif __name__ == "__main__":\n    main()\n'),
    ),
    "ops/npside.py": (
        ("from .matchkernel import match_kernel\n",
         "from .npeval import EvalEnv, eval_program, match_kernel\n"),
        ("from .vexpr import EvalEnv, eval_program\n", ""),
    ),
}


# (pattern, replacement), in order: the tags name the JAX package's
# issues, PRs and review rounds, which mean nothing in the port; every
# match lies in a comment or a docstring
SCRUB = (
    (r" \(ISSUE \d+[^(),\n]*\)", ""),
    (r"\(ISSUE \d+, ", "("),
    (r", ISSUE \d+\)", ")"),
    (r"ISSUE \d+ ", ""),
    (r" \(r\d+ VERDICT #\d+\)", ""),
    (r"PR 2 instrumented (.*) and PR 4 added",
     r"Earlier work instrumented \1 and added"),
    (r"the PR (\d+)\n(\s*)(#?\s*)", r"the\n\2\3"),
    (r" / PR \d+ ", " / "),
    (r" \(round-\d+ VERDICT: [^)]*\)", ""),
    (r" ISSUE \d+,\n(\s*)docs/", r"\n\1docs/"),
    (r" \(ISSUE \d+,\n(\s*)# ([^)]*)\)", r"\n\1# (\2)"),
    (r"the PR \d+ slow-client", "the slow-client"),
    (r"\(PR \d+ contract, ", "("),
    (r" \(the PR \d+ machinery\)", ""),
    (r"the PR \d+ contention", "spawn_fleet's contention"),
    (r"the PR \d+ ", "the "),
    (r"\(ISSUE \d+ ", "("),
    (r" —\nISSUE \d+\.\n", ".\n"),
    (r" — ISSUE \d+\.", "."),
    (r" before\n(\s*)ISSUE \d+\.", r"\n\1before it was bounded."),
    (r"PR \d+ made admission", "Earlier work made admission"),
    (r" \(PR \d+\)", ""),
    (r"\* PR \d+: ", "* "),
    (r"\(PR \d+ shape\)", "(the stall shape)"),
)
TAGS = re.compile(r"ISSUE \d|\bPR \d|VERDICT")


def _renamed(text: str) -> str:
    text = text.replace("gatekeeper_tpu", "gatekeeper_tpu_torch")
    for pattern, replacement in SCRUB:
        text = re.sub(pattern, replacement, text)
    return text


def _pieces(text: str) -> dict:
    """name -> source of each top-level function, class method and
    assignment; every other top-level statement keyed by its own text."""
    tree = ast.parse(text)
    out = {}

    def name_of(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return node.name
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            return node.targets[0].id
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            return node.target.id
        return None

    for node in tree.body:
        src = ast.get_source_segment(text, node, padded=True)
        name = name_of(node)
        if isinstance(node, ast.ClassDef):
            head = []
            for sub in node.body:
                sub_name = name_of(sub)
                sub_src = ast.get_source_segment(text, sub, padded=True)
                if sub_name is None:
                    head.append(sub_src)
                else:
                    out[f"{node.name}.{sub_name}"] = sub_src
            out[node.name] = "\n".join(
                [ast.unparse(b) for b in node.bases]
                + [ast.unparse(d) for d in node.decorator_list] + head)
        elif name is not None:
            out[name] = src
        else:
            out[f"<{src}>"] = src
    return out


def test_the_list_covers_every_copied_file():
    """Every port file with a JAX twin of the same path, other than the
    modules earlier slices ported by hand, is listed as a copy."""
    earlier = {
        p.relative_to(PORT_PKG).as_posix()
        for p in PORT_PKG.rglob("*.py")
        if (JAX_PKG / p.relative_to(PORT_PKG)).exists()
    } - set(COPIED)
    # modules of the earlier slices: the engine, the client, the target,
    # the rego front end and the ops / parallel layers they rewrote
    assert all(
        path.split("/")[0] in {"client", "engine", "rego", "target", "ops",
                               "parallel", "native", "apis", "util"}
        or path in {"__init__.py", "version.py"}
        for path in earlier
    ), sorted(earlier)
    assert set(CHANGED) | set(REPLACED) <= set(COPIED)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_the_jax_module_but_for_its_named_changes(rel):
    jax_text = _renamed((JAX_PKG / rel).read_text())
    port_text = (PORT_PKG / rel).read_text()
    assert not TAGS.search(port_text), f"{rel} keeps a provenance tag"
    for old, new in REPLACED.get(rel, ()):
        assert jax_text.count(old) == 1
        assert not new or port_text.count(new) == 1
        jax_text = jax_text.replace(old, new)
    changed = CHANGED.get(rel, set())
    if not changed:
        assert port_text == jax_text, f"{rel} differs from its JAX twin"
        return
    want, got = _pieces(jax_text), _pieces(port_text)
    missing = changed - set(got)
    assert not missing, f"{rel}: named changes not found: {missing}"
    for name in sorted(set(want) | set(got)):
        if name in changed:
            continue
        assert name in want, f"{rel}: {name!r} added but not named"
        assert name in got, f"{rel}: {name!r} removed but not named"
        assert got[name] == want[name], f"{rel}: {name!r} differs"
    # the module docstring and imports are pieces too: unchanged
    assert ast.get_docstring(ast.parse(port_text)) == ast.get_docstring(
        ast.parse(jax_text))


def test_a_changed_function_is_really_changed():
    """No name stays on the exception list once it equals the JAX one."""
    for rel, names in CHANGED.items():
        want = _pieces(_renamed((JAX_PKG / rel).read_text()))
        got = _pieces((PORT_PKG / rel).read_text())
        for name in names:
            assert got[name] != want.get(name), f"{rel}: {name} unchanged"


def _without_docstring(text: str) -> tuple:
    """(the module docstring, the pieces of everything else)."""
    tree = ast.parse(text)
    pieces = _pieces(text)
    doc = ast.get_docstring(tree)
    if doc is not None:
        pieces.pop(f"<{ast.get_source_segment(text, tree.body[0], padded=True)}>")
    return doc, pieces


@pytest.mark.parametrize("rel", sorted(TOOLS))
def test_a_copied_tool_equals_the_jax_tool_but_for_its_named_changes(rel):
    jax_rel, changed = TOOLS[rel]
    port_text = (ROOT / rel).read_text()
    assert not TAGS.search(port_text), f"{rel} keeps a provenance tag"
    want_doc, want = _without_docstring(_renamed((ROOT / jax_rel)
                                                 .read_text()))
    got_doc, got = _without_docstring(port_text)
    assert (got_doc != want_doc) == ("__doc__" in changed), rel
    for name in sorted(set(want) | set(got)):
        assert name in want or name in changed, \
            f"{rel}: {name!r} added but not named"
        assert name in got, f"{rel}: {name!r} removed"
        if name in changed:
            assert got[name] != want.get(name), f"{rel}: {name} unchanged"
        else:
            assert got[name] == want[name], f"{rel}: {name!r} differs"
