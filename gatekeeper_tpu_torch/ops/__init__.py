"""Device backend: columnar packing, the vectorized match and violation
evaluation in PyTorch (CUDA kernels K1-K10 on the card), and TorchDriver.

- The audit sweep constraints x resources is one batched boolean-tensor
  evaluation on the device; admission reviews batch onto the same path.
- Violation predicates compiled from the Rego AST may OVER-approximate
  (never under-): positive cells are re-rendered on the host, so false
  positives cost render time, never correctness.
"""
