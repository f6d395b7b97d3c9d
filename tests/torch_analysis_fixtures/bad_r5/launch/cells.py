class CellProgram:
    def __init__(self, fn, args, donate=()):
        self.fn, self.args, self.donate = fn, args, donate


def build_cell(arch, cell, mesh):
    return CellProgram(lambda *a: a, (1, 2), donate=(0, 1))
