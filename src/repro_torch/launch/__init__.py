"""Step functions and programs of the port (`steps`, `program`) and its
mesh builders (`mesh`)."""
