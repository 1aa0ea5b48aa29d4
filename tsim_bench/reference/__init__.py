"""The benchmark's plain reference (`tsim_ref`, a frozen copy of the
port's plain path)."""
