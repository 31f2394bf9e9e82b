"""Testing support — deterministic chaos (faultinject) and harness glue.

Nothing here runs unless explicitly armed (a fault plan in the
environment / MCA vars); importing this package from production paths is
free.
"""
