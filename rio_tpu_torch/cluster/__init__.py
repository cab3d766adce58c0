"""Cluster control plane: membership storage + membership protocols."""
