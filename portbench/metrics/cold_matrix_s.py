"""The wall of the run's first matrix, in the fresh process after the
kernel libraries are loaded: what each CLI call pays beyond a warm one."""


def read(record):
    return record.get("cold_matrix_s")
