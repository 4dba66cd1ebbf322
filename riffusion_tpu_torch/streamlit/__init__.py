"""The playground's streamlit UI, the counterpart of riffusion_tpu/streamlit/.
`streamlit` is an optional dependency: each page's logic is in plain
functions (importable and tested without it); only the render() bodies
touch st."""
