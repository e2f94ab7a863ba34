"""Host I/O: video sources (the file reader, the synthetic road stream
rendered on the device), the LKRAW container and its native reader, chunk
prefetchers and the output sinks."""
