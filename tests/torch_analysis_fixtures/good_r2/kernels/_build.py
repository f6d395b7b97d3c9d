class CudaLibrary:
    def __init__(self, source, signatures):
        self.source, self.signatures = source, signatures
