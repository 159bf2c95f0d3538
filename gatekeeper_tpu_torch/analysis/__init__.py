"""gklint — repo-invariant static analysis for gatekeeper_tpu_torch.

The concurrency and tracing invariants this data plane depends on were
each learned the hard way (the mesh AllReduce rendezvous deadlock,
the cv-held-driver-lock stall, wedged-pipe reader hangs); gklint
machine-checks them on every run instead of rediscovering them in review.

CLI: ``python tools/gklint.py [paths...]``; wired into tier-1 via
tests/test_gklint_tool.py.  Rule catalog + incident history:
docs/static-analysis.md.

Pass families (each module registers its rules on import):

  locks          lock-order cycles, blocking calls under locks, locks
                 acquired under condition variables
  tracesafety    tracer truthiness / jit-in-loop / impure calls in
                 compiled regions
  failpolicy     silently swallowed exceptions on admission/audit paths
  hygiene        thread daemon/join, bare joins, listener close,
                 idempotent start()
  queuebound     unbounded queues (queue.Queue() without maxsize,
                 list-backed pending queues on serving paths)
  evloopsafety   blocking socket calls inside selectors-based
                 event-loop modules
  registrycheck  fault-point and metric registries vs their docs
"""

from .core import (  # noqa: F401
    BASELINE_NAME,
    PASSES,
    RULES,
    Finding,
    Module,
    Project,
    apply_baseline,
    load_baseline,
    run_passes,
    write_baseline,
)

# importing the pass modules registers them with core.PASSES
from . import evloopsafety  # noqa: F401,E402
from . import failpolicy  # noqa: F401,E402
from . import hygiene  # noqa: F401,E402
from . import locks  # noqa: F401,E402
from . import queuebound  # noqa: F401,E402
from . import registrycheck  # noqa: F401,E402
from . import tracesafety  # noqa: F401,E402


def lint(root: str, paths, exclude=(), select=None):
    """Parse `paths` (files/dirs) under repo `root` and run every pass.
    Returns the suppression-filtered findings (baseline NOT applied)."""
    project = Project.load(root, paths, exclude=exclude)
    return run_passes(project, select=select)
