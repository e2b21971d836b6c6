"""Host- and device-side physics: k-points and band structures."""
