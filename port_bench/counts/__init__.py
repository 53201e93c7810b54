"""Operations, bytes and peaks: the roofline arithmetic of the benchmark."""
