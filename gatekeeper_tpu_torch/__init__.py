"""gatekeeper_tpu_torch — the policy-enforcement engine in PyTorch and CUDA.

The port of gatekeeper_tpu's evaluation path to an NVIDIA H100: the same
ConstraintTemplate compiler (rego/, engine/, ops/vectorizer.py), the same
packed host state, and device work in PyTorch with four hand-written CUDA
kernels (kernels/*.cu).  It imports neither JAX nor gatekeeper_tpu.

  client/   constraint-framework Client and the Driver seam
  ops/      packing, the VExpr evaluator, the kernels' wrappers, TorchDriver
  parallel/ the audit sweep sharded over a mesh of devices or processes
  device.py device selection and the kernels' build and loader
  convert.py packed host state -> tensors on a device
"""

__version__ = "0.1.0"
