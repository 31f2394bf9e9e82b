"""The port's runtime: the launcher, PMIx, and the job model (host
process mode)."""
