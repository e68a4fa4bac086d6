"""Traffic generators: one module a traffic `kind`, each reading its
parameters from gpubench/traffic/<name>.json."""
