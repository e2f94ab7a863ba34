"""Host I/O: chunk prefetchers and the output sinks."""
