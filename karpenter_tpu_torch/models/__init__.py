"""Intentionally empty: the reference (sigs.k8s.io/karpenter) is a
control-plane node autoscaler, not an ML framework - it contains no model
families (SURVEY.md §2.9). The scaffold keeps this package so the standard
layout (models/ ops/ parallel/ utils/) holds; the framework's "models" are
the solver programs in ops/ and provisioning/."""
