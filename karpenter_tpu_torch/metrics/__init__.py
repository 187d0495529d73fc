"""Process metrics: the trimmed copy of `karpenter_tpu/metrics`."""
